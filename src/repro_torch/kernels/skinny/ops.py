"""Wrappers of the skinny (decode-shaped, M ≤ 32) kernels:
`dbb_gemm_skinny` (csrc/dbb_gemm_skinny.cu) streams the compressed DBB
planes (f32, int8 or w4 values), `sta_gemm_skinny`
(csrc/sta_gemm_skinny.cu) a dense weight. On a CUDA tensor each launches
its kernel (or raises); on a CPU tensor it runs the plain version."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (FLOAT_DTYPES, LAUNCHES, SKINNY_M_MAX,
                                        check_operand, coerce_bias_scale)
from repro_torch.kernels.dbb_gemm.ops import check_dbb_operands, run_dbb_kernel
from repro_torch.kernels.epilogue import ACT_CODES
from repro_torch.kernels.skinny.ref import dbb_gemm_ref, sta_gemm_ref

__all__ = ["dbb_gemm_skinny", "sta_gemm_skinny"]


def _check_m(m: int) -> None:
    if not 1 <= m <= SKINNY_M_MAX:
        raise ValueError(f"M={m} outside the skinny regime [1, "
                         f"{SKINNY_M_MAX}]")


def dbb_gemm_skinny(x: torch.Tensor, values: torch.Tensor,
                    bitmask: torch.Tensor, bias=None, scale=None, *,
                    act: str = "none", block: int = 8, nnz: int = 4,
                    out_dtype: Optional[torch.dtype] = None, bits: int = 8,
                    group: int = 0, gscale: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Skinny DBB GEMM; output ``[..., N]`` in x's dtype. The values
    planes are those of `dbb_gemm` (f32, int8, or the w4 nibble plane with
    ``gscale``), counted as ``dbb_gemm_skinny``, ``dbb_gemm_skinny_i8``,
    ``dbb_gemm_skinny_w4``."""
    x2, m, k_dim, n, plane = check_dbb_operands(
        x, values, bitmask, block=block, nnz=nnz, out_dtype=out_dtype,
        bits=bits, group=group, gscale=gscale)
    _check_m(m)
    bias, scale = coerce_bias_scale(bias, scale, n, x.device)
    if x.device.type == "cpu":
        y = dbb_gemm_ref(x2, values, bitmask, bias, scale, act=act,
                         block=block, bits=bits, group=group, gscale=gscale)
    else:
        y = run_dbb_kernel("dbb_gemm_skinny", plane, x2, values, bitmask,
                           bias, scale, m=m, k_dim=k_dim, n=n, nnz=nnz,
                           act=act, group=group, gscale=gscale)
    return y.reshape(*x.shape[:-1], n)


def _sta_launcher():
    fn = build.load("sta_gemm_skinny").sta_gemm_skinny_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sta_gemm_skinny(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None,
                    *, act: str = "none",
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Skinny dense GEMM ``x [..., K] @ w [K, N]`` (w in x's dtype);
    output ``[..., N]`` in x's dtype."""
    k_dim, n = w.shape
    x2 = x.reshape(-1, k_dim)
    m = x2.shape[0]
    _check_m(m)
    if k_dim % 8:
        raise ValueError(f"K={k_dim} not a multiple of 8 (the kernel "
                         "streams 8-row groups)")
    if out_dtype not in (None, x.dtype):
        raise TypeError(f"out_dtype {out_dtype}: the kernel stores x's "
                        f"dtype {x.dtype}")
    check_operand("x", x2, (m, k_dim), FLOAT_DTYPES, x.device)
    check_operand("w", w, (k_dim, n), (x.dtype,), x.device)
    bias, scale = coerce_bias_scale(bias, scale, n, x.device)
    if x.device.type == "cpu":
        y = sta_gemm_ref(x2, w, bias, scale, act=act)
    else:
        y = torch.empty((m, n), dtype=x.dtype, device=x.device)
        rc = _sta_launcher()(
            x2.data_ptr(), w.data_ptr(), build.ptr(scale), build.ptr(bias),
            y.data_ptr(), m, k_dim, n, ACT_CODES[act],
            build.dtype_code(x.dtype), build.stream_handle(x.device))
        if rc != 0:
            raise RuntimeError(f"sta_gemm_skinny launch failed: "
                               f"cudaError {rc}")
        LAUNCHES["sta_gemm_skinny"] += 1
    return y.reshape(*x.shape[:-1], n)
