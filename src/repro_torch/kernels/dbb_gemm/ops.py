"""Wrapper of the M-tiled DBB GEMM kernel (csrc/dbb_gemm.cu).

``dbb_gemm(x, values, bitmask, ...)`` computes
``act(scale * (x @ unpack(values, bitmask)) + bias)`` for ``x [..., K]``.
On a CUDA tensor it launches the kernel (or raises); on a CPU tensor it
runs the plain version, `dbb_gemm_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (FLOAT_DTYPES, LAUNCHES,
                                        check_operand, coerce_bias_scale)
from repro_torch.kernels.dbb_gemm.ref import dbb_gemm_ref
from repro_torch.kernels.epilogue import ACT_CODES

__all__ = ["dbb_gemm", "check_dbb_operands", "dbb_launcher"]


def check_dbb_operands(x: torch.Tensor, values: torch.Tensor,
                       bitmask: torch.Tensor, *, block: int, nnz: int,
                       out_dtype: Optional[torch.dtype]
                       ) -> Tuple[torch.Tensor, int, int, int]:
    """Validate the operands both DBB kernels take; returns
    ``(x [M, K], M, K, N)``. Raises on anything the kernels do not take."""
    if block != 8:
        raise ValueError(f"DBB block {block}: the kernels take B = 8")
    if not 1 <= nnz <= 8:
        raise ValueError(f"nnz={nnz} outside [1, 8]")
    k_dim = x.shape[-1]
    x2 = x.reshape(-1, k_dim)
    m, n = x2.shape[0], values.shape[-1]
    if k_dim % block:
        raise ValueError(f"K={k_dim} not a multiple of the block {block}")
    if out_dtype not in (None, x.dtype):
        raise TypeError(f"out_dtype {out_dtype}: the kernels store x's "
                        f"dtype {x.dtype}")
    dev = x.device
    check_operand("x", x2, (m, k_dim), FLOAT_DTYPES, dev)
    check_operand("values", values, (k_dim // block * nnz, n),
                  (torch.float32,), dev)
    check_operand("bitmask", bitmask, (k_dim // block, n), (torch.int32,),
                  dev)
    return x2, m, k_dim, n


def dbb_launcher(name: str) -> ctypes._CFuncPtr:
    """The C launcher ``<name>_launch`` of a DBB kernel, typed."""
    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def run_dbb_kernel(name: str, x2, values, bitmask, bias, scale, *, m, k_dim,
                   n, nnz, act) -> torch.Tensor:
    """Launch DBB kernel ``name`` on the current stream; count the launch."""
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    rc = dbb_launcher(name)(
        x2.data_ptr(), values.data_ptr(), bitmask.data_ptr(),
        build.ptr(scale), build.ptr(bias), out.data_ptr(), m, k_dim, n, nnz,
        ACT_CODES[act], build.dtype_code(x2.dtype),
        build.stream_handle(x2.device))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


def dbb_gemm(x: torch.Tensor, values: torch.Tensor, bitmask: torch.Tensor,
             bias=None, scale=None, *, act: str = "none", block: int = 8,
             nnz: int = 4, out_dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
    """M-tiled DBB GEMM (any M); output ``[..., N]`` in x's dtype."""
    x2, m, k_dim, n = check_dbb_operands(x, values, bitmask, block=block,
                                         nnz=nnz, out_dtype=out_dtype)
    bias, scale = coerce_bias_scale(bias, scale, n, x.device)
    if x.device.type == "cpu":
        y = dbb_gemm_ref(x2, values, bitmask, bias, scale, act=act,
                         block=block)
    else:
        y = run_dbb_kernel("dbb_gemm", x2, values, bitmask, bias, scale,
                           m=m, k_dim=k_dim, n=n, nnz=nnz, act=act)
    return y.reshape(*x.shape[:-1], n)
