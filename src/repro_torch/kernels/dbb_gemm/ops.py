"""Wrapper of the M-tiled DBB GEMM kernel (csrc/dbb_gemm.cu).

``dbb_gemm(x, values, bitmask, ...)`` computes
``act(scale * (x @ unpack(values, bitmask)) + bias)`` for ``x [..., K]``.
The values plane is f32 or int8 ``[K/8·k, N]``, or at ``bits=4`` the
nibble plane ``[K/8·k/2, N]`` int8 with groupwise scales ``gscale [K/G,
N]``; each format has its own launcher and launch counter (``dbb_gemm``,
``dbb_gemm_i8``, ``dbb_gemm_w4``). int8 activations take the int8 branch
on the INT8 values plane (``dbb_gemm_s8``: INT8 × INT8 → INT32, stored
as int32 by default, f32 with a scale, or int8 requantized); the w4 plane
takes float x only, as in the reference. On a CUDA tensor it launches the
kernel (or raises); on a CPU tensor it runs the plain version,
`dbb_gemm_ref`.

Four bodies (csrc/dbb_gemm.cu), by rules that never read M: bf16 x runs
on the tensor-core body on every values plane (the planes decompressed
into shared memory, wgmma on them) and counts as ``dbb_gemm_tc`` too
(`tc_body`); f32 x at N <= 16 (the CNN classifier) runs the narrow
split-K body and counts as ``dbb_gemm_narrow`` too (`narrow_body`); int8
x with K and N multiples of 16 runs on the int8 tensor-core body (the
INT8 plane decompressed into K-major int8 tiles, s8 wgmma) and counts as
``dbb_gemm_s8_tc`` too (`s8_tc_body`); other f32 x and int8 x run the
plain-FMA (IMAD) body.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (FLOAT_DTYPES, LAUNCHES,
                                        OPERAND_DTYPES, check_operand,
                                        coerce_bias_scale, resolve_out_dtype)
from repro_torch.kernels.dbb_gemm.ref import dbb_gemm_ref
from repro_torch.kernels.epilogue import ACT_CODES

__all__ = ["dbb_gemm", "check_dbb_operands", "dbb_launcher",
           "run_dbb_kernel", "tc_body", "narrow_body", "s8_tc_body"]


def tc_body(dtype: torch.dtype) -> bool:
    """Whether the kernel runs x of this dtype on its tensor-core body:
    bf16 (x's rows are copied by TMA, which the DBB operands' K % 8 == 0
    allows). The rule of csrc/dbb_gemm.cu's tc_body; it reads no shape."""
    return dtype == torch.bfloat16


def narrow_body(dtype: torch.dtype, n: int) -> bool:
    """Whether the kernel runs x of this dtype at N output columns on its
    narrow split-K body: f32 x at N <= 16 (one 16-column tile; K split
    across a thread-block cluster). The rule of csrc/dbb_gemm.cu's
    narrow_body; it reads no M."""
    return dtype == torch.float32 and n <= 16


def s8_tc_body(k: int, n: int) -> bool:
    """Whether the kernel's int8-activation branch runs on its int8
    tensor-core body: K and N multiples of 16 (TMA copies x's int8 rows and
    the planes' rows, 16-byte strides). The rule of csrc/dbb_gemm.cu's
    s8_tc_body, which only the int8 launcher reads; it reads no M."""
    return k % 16 == 0 and n % 16 == 0


def check_dbb_operands(x: torch.Tensor, values: torch.Tensor,
                       bitmask: torch.Tensor, *, block: int, nnz: int,
                       out_dtype: Optional[torch.dtype], bits: int = 8,
                       group: int = 0, gscale: Optional[torch.Tensor] = None,
                       has_scale: bool = False
                       ) -> Tuple[torch.Tensor, int, int, int, str,
                                  torch.dtype]:
    """Validate the operands both DBB kernels take; returns
    ``(x [M, K], M, K, N, plane, out dtype)`` with ``plane`` the launcher
    suffix of the branch ("" f32 values, "_i8" int8 values, "_w4" the
    nibble plane, all for float x; "_s8" int8 x on int8 values). Raises
    on anything the kernels do not take."""
    if block != 8:
        raise ValueError(f"DBB block {block}: the kernels take B = 8")
    if not 1 <= nnz <= 8:
        raise ValueError(f"nnz={nnz} outside [1, 8]")
    k_dim = x.shape[-1]
    x2 = x.reshape(-1, k_dim)
    m, n = x2.shape[0], values.shape[-1]
    if k_dim % block:
        raise ValueError(f"K={k_dim} not a multiple of the block {block}")
    dev = x.device
    int8_x = x.dtype == torch.int8
    check_operand("x", x2, (m, k_dim),
                  FLOAT_DTYPES if bits == 4 else OPERAND_DTYPES, dev)
    out_dtype = resolve_out_dtype(x.dtype, out_dtype, has_scale)
    rows = k_dim // block * nnz
    if bits == 4:
        if group <= 0 or group % block or k_dim % group:
            raise ValueError(f"group={group} must be a positive multiple "
                             f"of the block {block} dividing K={k_dim}")
        if rows % 2:
            raise ValueError(f"K/8·k = {rows} compressed rows: the nibble "
                             "plane needs an even count")
        check_operand("values", values, (rows // 2, n), (torch.int8,), dev)
        if gscale is None:
            raise ValueError("bits=4 needs the groupwise gscale plane")
        check_operand("gscale", gscale, (k_dim // group, n),
                      (torch.float32,), dev)
        plane = "_w4"
    elif bits == 8:
        if gscale is not None:
            raise ValueError("gscale is the bits=4 plane's; bits=8 scales "
                             "ride the epilogue")
        check_operand("values", values, (rows, n),
                      (torch.int8,) if int8_x else (torch.float32,
                                                    torch.int8), dev)
        plane = ("_s8" if int8_x else
                 "_i8" if values.dtype == torch.int8 else "")
    else:
        raise ValueError(f"bits={bits} not supported (4 or 8)")
    check_operand("bitmask", bitmask, (k_dim // block, n), (torch.int32,),
                  dev)
    return x2, m, k_dim, n, plane, out_dtype


def dbb_launcher(name: str, plane: str = "",
                 work: bool = False) -> ctypes._CFuncPtr:
    """The C launcher ``<name><plane>_launch`` of a DBB kernel, typed (the
    w4 launcher also takes the gscale pointer and the group; ``work``: a
    workspace pointer follows the output's)."""
    fn = getattr(build.load(name), f"{name}{plane}_launch")
    ptrs = 7 if work else 6
    if plane == "_w4":
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] * (ptrs - 3) + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    else:
        fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def run_dbb_kernel(name: str, plane: str, x2, values, bitmask, bias, scale,
                   *, m, k_dim, n, nnz, act, out_dtype, group=0,
                   gscale=None, work: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Launch DBB kernel ``name`` on its ``plane`` branch on the current
    stream; count the launch under ``name + plane``. The float branches
    take x's dtype code (they store it), the ``_s8`` branch the output's;
    ``work``, where given, is the launcher's f32 workspace."""
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    head = [x2.data_ptr(), values.data_ptr(), bitmask.data_ptr()]
    if plane == "_w4":
        head += [gscale.data_ptr(), group]
    tail = [out.data_ptr()] + ([] if work is None else [work.data_ptr()])
    rc = dbb_launcher(name, plane, work is not None)(
        *head, build.ptr(scale), build.ptr(bias), *tail, m, k_dim,
        n, nnz, ACT_CODES[act],
        build.dtype_code(out_dtype if plane == "_s8" else x2.dtype),
        build.stream_handle(x2.device))
    if rc != 0:
        raise RuntimeError(f"{name}{plane} launch failed: cudaError {rc}")
    LAUNCHES[name + plane] += 1
    return out


def dbb_gemm(x: torch.Tensor, values: torch.Tensor, bitmask: torch.Tensor,
             bias=None, scale=None, *, act: str = "none", block: int = 8,
             nnz: int = 4, out_dtype: Optional[torch.dtype] = None,
             bits: int = 8, group: int = 0,
             gscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """M-tiled DBB GEMM (any M); output ``[..., N]`` in x's dtype (float
    x) or ``out_dtype`` (int8 x: int32, f32 or int8)."""
    x2, m, k_dim, n, plane, out_dtype = check_dbb_operands(
        x, values, bitmask, block=block, nnz=nnz, out_dtype=out_dtype,
        bits=bits, group=group, gscale=gscale, has_scale=scale is not None)
    bias, scale = coerce_bias_scale(bias, scale, n, x.device)
    if x.device.type == "cpu":
        y = dbb_gemm_ref(x2, values, bitmask, bias, scale, act=act,
                         block=block, bits=bits, group=group, gscale=gscale,
                         out_dtype=out_dtype)
    elif x.device.type == "meta":
        y = torch.empty((m, n), dtype=out_dtype, device="meta")
    else:
        y = run_dbb_kernel("dbb_gemm", plane, x2, values, bitmask, bias,
                           scale, m=m, k_dim=k_dim, n=n, nnz=nnz, act=act,
                           out_dtype=out_dtype, group=group, gscale=gscale)
        if tc_body(x.dtype):
            LAUNCHES["dbb_gemm_tc"] += 1
        elif narrow_body(x.dtype, n):
            LAUNCHES["dbb_gemm_narrow"] += 1
        elif plane == "_s8" and s8_tc_body(k_dim, n):
            LAUNCHES["dbb_gemm_s8_tc"] += 1
    return y.reshape(*x.shape[:-1], n)
