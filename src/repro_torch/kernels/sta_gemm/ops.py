"""Wrapper of the M-tiled dense GEMM kernel (csrc/sta_gemm.cu).

``sta_gemm(x, w, ...)`` computes ``act(scale * (x @ w) + bias)`` for
``x [..., K]`` and ``w [K, N]`` of x's dtype (f32 or bf16), accumulated
in f32, stored in ``out_dtype`` (x's dtype by default). On a CUDA tensor
it launches the kernel (or raises); on a CPU tensor it runs the plain
version, `sta_gemm_ref`. Any M, K and N: the kernel masks the ragged
edges, so nothing is padded.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (FLOAT_DTYPES, LAUNCHES,
                                        check_operand, coerce_bias_scale)
from repro_torch.kernels.epilogue import ACT_CODES
from repro_torch.kernels.sta_gemm.ref import sta_gemm_ref

__all__ = ["sta_gemm"]


def _launcher():
    fn = build.load("sta_gemm").sta_gemm_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def sta_gemm(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None, *,
             act: str = "none", out_dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
    """Dense GEMM (any M); output ``[..., N]`` in ``out_dtype``."""
    k_dim, n = w.shape
    x2 = x.reshape(-1, k_dim)
    m = x2.shape[0]
    out_dtype = out_dtype or x.dtype
    if out_dtype not in FLOAT_DTYPES:
        raise TypeError(f"out_dtype {out_dtype} not in {FLOAT_DTYPES}")
    check_operand("x", x2, (m, k_dim), FLOAT_DTYPES, x.device)
    check_operand("w", w, (k_dim, n), (x.dtype,), x.device)
    bias, scale = coerce_bias_scale(bias, scale, n, x.device)
    if x.device.type == "cpu" or m * n == 0:    # no empty grid launches
        y = sta_gemm_ref(x2, w, bias, scale, act=act, out_dtype=out_dtype)
    else:
        y = torch.empty((m, n), dtype=out_dtype, device=x.device)
        rc = _launcher()(
            x2.data_ptr(), w.data_ptr(), build.ptr(scale), build.ptr(bias),
            y.data_ptr(), m, k_dim, n, ACT_CODES[act],
            build.dtype_code(x.dtype), build.dtype_code(out_dtype),
            build.stream_handle(x.device))
        if rc != 0:
            raise RuntimeError(f"sta_gemm launch failed: cudaError {rc}")
        LAUNCHES["sta_gemm"] += 1
    return y.reshape(*x.shape[:-1], n)
