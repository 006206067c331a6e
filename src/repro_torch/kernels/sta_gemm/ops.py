"""Wrapper of the M-tiled dense GEMM kernel (csrc/sta_gemm.cu).

``sta_gemm(x, w, ...)`` computes ``act(scale * (x @ w) + bias)`` for
``x [..., K]`` and ``w [K, N]`` of x's dtype. Float operands (f32 or
bf16) accumulate in f32 and store ``out_dtype`` (x's dtype by default);
int8 operands take the kernel's int8 branch (``sta_gemm_s8``: an exact
int32 accumulator) and store int32 by default, f32 with a scale, or int8
requantized. On a CUDA tensor it launches the kernel (or raises); on a
CPU tensor it runs the plain version, `sta_gemm_ref`. Any M, K and N: the
kernel masks the ragged edges, so nothing is padded.

Three bodies (csrc/sta_gemm.cu), by rules on (dtype, K, N) that never
read M: bf16 operands with K and N multiples of 8 run on the tensor-core
body (wgmma on TMA-fed tiles) and count as ``sta_gemm_tc`` too
(`tc_body`); int8 operands with K and N multiples of 16 run on the int8
tensor-core body (s8 wgmma, w's tiles made K-major in shared memory) and
count as ``sta_gemm_s8_tc`` too (`s8_tc_body`); f32 operands and the
ragged rest run the plain-FMA (IMAD) body.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (FLOAT_DTYPES, LAUNCHES,
                                        OPERAND_DTYPES, check_operand,
                                        coerce_bias_scale, resolve_out_dtype)
from repro_torch.kernels.epilogue import ACT_CODES
from repro_torch.kernels.sta_gemm.ref import sta_gemm_ref

__all__ = ["sta_gemm", "tc_body", "s8_tc_body"]


def tc_body(dtype: torch.dtype, k: int, n: int) -> bool:
    """Whether the kernel runs these operands on its tensor-core body: bf16
    with K and N multiples of 8 (the 16-byte row strides TMA copies x
    [M, K] and w [K, N] by). The rule of csrc/sta_gemm.cu's tc_body; it
    reads no M."""
    return dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0


def s8_tc_body(k: int, n: int) -> bool:
    """Whether the kernel's int8 branch runs these operands on its int8
    tensor-core body: K and N multiples of 16 (the 16-byte row strides TMA
    copies int8 x [M, K] and w [K, N] by). The rule of csrc/sta_gemm.cu's
    s8_tc_body, which only the int8 launcher reads; it reads no M."""
    return k % 16 == 0 and n % 16 == 0


def _launcher(branch: str = ""):
    """``sta_gemm_launch`` (float operands: x and out dtype codes) or
    ``sta_gemm_s8_launch`` (int8 operands: the out dtype code)."""
    fn = getattr(build.load("sta_gemm"), f"sta_gemm{branch}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int] * (5 if branch else 6)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def sta_gemm(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None, *,
             act: str = "none", out_dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
    """Dense GEMM (any M); output ``[..., N]`` in ``out_dtype``; int8
    operands count as ``sta_gemm_s8``."""
    k_dim, n = w.shape
    x2 = x.reshape(-1, k_dim)
    m = x2.shape[0]
    out_dtype = resolve_out_dtype(x.dtype, out_dtype, scale is not None,
                                  FLOAT_DTYPES)
    check_operand("x", x2, (m, k_dim), OPERAND_DTYPES, x.device)
    check_operand("w", w, (k_dim, n), (x.dtype,), x.device)
    bias, scale = coerce_bias_scale(bias, scale, n, x.device)
    if x.device.type == "cpu" or m * n == 0:    # no empty grid launches
        y = sta_gemm_ref(x2, w, bias, scale, act=act, out_dtype=out_dtype)
    else:
        branch = "_s8" if x.dtype == torch.int8 else ""
        codes = ((build.dtype_code(out_dtype),) if branch else
                 (build.dtype_code(x.dtype), build.dtype_code(out_dtype)))
        y = torch.empty((m, n), dtype=out_dtype, device=x.device)
        if x.device.type == "meta":
            return y.reshape(*x.shape[:-1], n)
        rc = _launcher(branch)(
            x2.data_ptr(), w.data_ptr(), build.ptr(scale), build.ptr(bias),
            y.data_ptr(), m, k_dim, n, ACT_CODES[act], *codes,
            build.stream_handle(x.device))
        if rc != 0:
            raise RuntimeError(f"sta_gemm{branch} launch failed: "
                               f"cudaError {rc}")
        LAUNCHES["sta_gemm" + branch] += 1
        if branch and s8_tc_body(k_dim, n):
            LAUNCHES["sta_gemm_s8_tc"] += 1
        elif tc_body(x.dtype, k_dim, n):
            LAUNCHES["sta_gemm_tc"] += 1
    return y.reshape(*x.shape[:-1], n)
