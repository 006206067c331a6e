"""Wrappers of the skinny (decode-shaped, M ≤ 32) kernels:
`dbb_gemm_skinny` (csrc/dbb_gemm_skinny.cu) streams the compressed DBB
planes (f32, int8 or w4 values), `sta_gemm_skinny`
(csrc/sta_gemm_skinny.cu) a dense weight. int8 activations take each
kernel's int8 branch (``_s8``: INT8 × INT8 → INT32; int32 output by
default, f32 with a scale, or int8 requantized), the DBB one on the INT8
values plane. On a CUDA tensor each launches its kernel (or raises); on a
CPU tensor it runs the plain version.

`sta_gemm_skinny`'s float branch keeps all M <= 32 rows in one block
(persistent blocks over 64-column tiles; a TMA-fed weight ring), in the K
order that head_sample_fused shares, so its bits do not depend on M.

`dbb_gemm_skinny` runs float x on its split-K body (all M <= 32 rows in
one block, K split across blocks whose partial sums a second pass adds in
a fixed order from a workspace this wrapper allocates (`workspace_elems`),
the planes streamed
through a TMA or cp.async ring; bf16 x on mma.sync), counted as
``dbb_gemm_skinny_split`` too (`split_body`: the rule on x's dtype).

The int8 branches of both kernels run one int8 split-K body
(csrc/split_k_s8.cuh): all M <= 32 rows and 64 columns a block, K in
128-deep stages split over ``s8_splits(K, N)`` blocks, s8 mma.sync on
int32 accumulators; the slices' sums meet in a workspace this wrapper
allocates, added by a second launch. Integer sums are exact, so the
outputs equal the plain version's bit for bit."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (LAUNCHES, OPERAND_DTYPES,
                                        SKINNY_M_MAX, check_operand,
                                        coerce_bias_scale, resolve_out_dtype)
from repro_torch.kernels.dbb_gemm.ops import check_dbb_operands, run_dbb_kernel
from repro_torch.kernels.epilogue import ACT_CODES
from repro_torch.kernels.skinny.ref import dbb_gemm_ref, sta_gemm_ref

__all__ = ["dbb_gemm_skinny", "sta_gemm_skinny", "split_body", "splits",
           "s8_splits", "workspace_elems", "library_splits"]

# csrc/split_k.cuh: the most K slices (the largest portable cluster) and
# the H100 SXM's SMs
_MAX_SPLIT, _SMS = 8, 132
# the float split-K body (csrc/dbb_gemm_skinny.cu): 64 columns a block, 8
# DBB blocks of 8 (64 K) a stage
_COLS, _DBB_BLOCK, _STAGE_KB = 64, 8, 8
# the int8 body (csrc/split_k_s8.cuh): 64 columns a block, 128 K a stage
_S8_STAGE_K = 128


def _check_m(m: int) -> None:
    if not 1 <= m <= SKINNY_M_MAX:
        raise ValueError(f"M={m} outside the skinny regime [1, "
                         f"{SKINNY_M_MAX}]")


def splits(k_dim: int, n: int) -> int:
    """The float split-K body's K slices at (K, N): doubled while the grid
    holds under 2 blocks per SM, up to 8, as long as each slice keeps at
    least two stages (csrc/dbb_gemm_skinny.cu's splits, a rule on K and N
    alone)."""
    kb, tiles, s = k_dim // _DBB_BLOCK, -(-n // _COLS), 1
    while (s < _MAX_SPLIT and tiles * s < 2 * _SMS
           and kb >= 2 * s * 2 * _STAGE_KB):
        s *= 2
    return s


def s8_splits(k_dim: int, n: int) -> int:
    """The int8 body's K slices at (K, N): doubled while the grid stays
    within 2 blocks per SM and every slice keeps at least two 128-deep
    stages, up to 8 (csrc/split_k_s8.cuh's splits)."""
    stages, tiles, s = -(-k_dim // _S8_STAGE_K), -(-n // _COLS), 1
    while (s < _MAX_SPLIT and tiles * 2 * s <= 2 * _SMS
           and stages >= 2 * 2 * s):
        s *= 2
    return s


def workspace_elems(m: int, k_dim: int, n: int, dtype: torch.dtype) -> int:
    """Elements of the workspace a skinny call on x of ``dtype``
    allocates: each K slice's [M, N] partial sums, f32 (float x) or int32
    (int8 x). A pure function of the shapes; the wrappers allocate exactly
    this."""
    s = s8_splits(k_dim, n) if dtype == torch.int8 else splits(k_dim, n)
    return s * m * n


def library_splits(kernel: str, s8: bool, k_dim: int, n: int) -> int:
    """The slices as the kernel's library computes them:
    ``dbb_gemm_skinny_splits`` (the float body) or ``<kernel>_s8_splits``
    (the int8 body of either skinny kernel)."""
    fn = getattr(build.load(kernel),
                 f"{kernel}_s8_splits" if s8 else f"{kernel}_splits")
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(k_dim, n)


@functools.lru_cache(maxsize=None)
def _checked_splits(kernel: str, s8: bool, k_dim: int, n: int) -> int:
    """`splits` / `s8_splits`, held once per shape against the library's
    count: a workspace sized by a rule the kernel does not follow would
    be written past its end."""
    want = (s8_splits if s8 else splits)(k_dim, n)
    got = library_splits(kernel, s8, k_dim, n)
    if got != want:
        raise RuntimeError(f"{kernel}: the library splits K={k_dim} N={n} "
                           f"in {got}, the Python rule in {want}")
    return want


def _work(kernel: str, m: int, k_dim: int, n: int,
          dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    s8 = dtype == torch.int8
    if device.type != "meta":
        _checked_splits(kernel, s8, k_dim, n)
    return torch.empty((workspace_elems(m, k_dim, n, dtype),),
                       dtype=torch.int32 if s8 else torch.float32,
                       device=device)


def split_body(dtype: torch.dtype) -> bool:
    """Whether dbb_gemm_skinny runs x of this dtype on its split-K body:
    f32 and bf16. The rule of csrc/dbb_gemm_skinny.cu's split_body; it
    reads no shape."""
    return dtype in (torch.float32, torch.bfloat16)


def dbb_gemm_skinny(x: torch.Tensor, values: torch.Tensor,
                    bitmask: torch.Tensor, bias=None, scale=None, *,
                    act: str = "none", block: int = 8, nnz: int = 4,
                    out_dtype: Optional[torch.dtype] = None, bits: int = 8,
                    group: int = 0, gscale: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Skinny DBB GEMM; output ``[..., N]`` in x's dtype (float x) or
    ``out_dtype`` (int8 x). The values planes are those of `dbb_gemm`
    (f32, int8, or the w4 nibble plane with ``gscale``), counted as
    ``dbb_gemm_skinny``, ``dbb_gemm_skinny_i8``, ``dbb_gemm_skinny_w4``;
    int8 x on the int8 plane as ``dbb_gemm_skinny_s8``."""
    x2, m, k_dim, n, plane, out_dtype = check_dbb_operands(
        x, values, bitmask, block=block, nnz=nnz, out_dtype=out_dtype,
        bits=bits, group=group, gscale=gscale, has_scale=scale is not None)
    _check_m(m)
    bias, scale = coerce_bias_scale(bias, scale, n, x.device)
    if x.device.type == "cpu":
        y = dbb_gemm_ref(x2, values, bitmask, bias, scale, act=act,
                         block=block, bits=bits, group=group, gscale=gscale,
                         out_dtype=out_dtype)
    elif x.device.type == "meta":
        # the card's call holds its workspace beside the output
        work = _work("dbb_gemm_skinny", m, k_dim, n, x.dtype, x.device)
        y = torch.empty((m, n), dtype=out_dtype, device="meta")
        del work
    else:
        split = split_body(x.dtype)
        work = _work("dbb_gemm_skinny", m, k_dim, n, x.dtype, x.device)
        y = run_dbb_kernel("dbb_gemm_skinny", plane, x2, values, bitmask,
                           bias, scale, m=m, k_dim=k_dim, n=n, nnz=nnz,
                           act=act, out_dtype=out_dtype, group=group,
                           gscale=gscale, work=work)
        if split:
            LAUNCHES["dbb_gemm_skinny_split"] += 1
    return y.reshape(*x.shape[:-1], n)


def _sta_launcher(branch: str = ""):
    """``sta_gemm_skinny_launch`` (x's dtype code) or
    ``sta_gemm_skinny_s8_launch`` (the out dtype code; a workspace pointer
    follows the output's)."""
    fn = getattr(build.load("sta_gemm_skinny"),
                 f"sta_gemm_skinny{branch}_launch")
    fn.argtypes = [ctypes.c_void_p] * (6 if branch else 5) + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sta_gemm_skinny(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None,
                    *, act: str = "none",
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Skinny dense GEMM ``x [..., K] @ w [K, N]`` (w in x's dtype);
    output ``[..., N]`` in x's dtype (float x) or ``out_dtype`` (int8 x,
    counted as ``sta_gemm_skinny_s8``)."""
    k_dim, n = w.shape
    x2 = x.reshape(-1, k_dim)
    m = x2.shape[0]
    _check_m(m)
    if k_dim % 8:
        raise ValueError(f"K={k_dim} not a multiple of 8 (the kernel "
                         "streams 8-row groups)")
    out_dtype = resolve_out_dtype(x.dtype, out_dtype, scale is not None)
    check_operand("x", x2, (m, k_dim), OPERAND_DTYPES, x.device)
    check_operand("w", w, (k_dim, n), (x.dtype,), x.device)
    bias, scale = coerce_bias_scale(bias, scale, n, x.device)
    if x.device.type == "cpu":
        y = sta_gemm_ref(x2, w, bias, scale, act=act, out_dtype=out_dtype)
    else:
        branch = "_s8" if x.dtype == torch.int8 else ""
        y = torch.empty((m, n), dtype=out_dtype, device=x.device)
        work = (_work("sta_gemm_skinny", m, k_dim, n, x.dtype, x.device)
                if branch else None)
        if x.device.type == "meta":
            return y.reshape(*x.shape[:-1], n)
        rc = _sta_launcher(branch)(
            x2.data_ptr(), w.data_ptr(), build.ptr(scale), build.ptr(bias),
            y.data_ptr(), *([work.data_ptr()] if branch else []), m, k_dim,
            n, ACT_CODES[act],
            build.dtype_code(out_dtype if branch else x.dtype),
            build.stream_handle(x.device))
        if rc != 0:
            raise RuntimeError(f"sta_gemm_skinny{branch} launch failed: "
                               f"cudaError {rc}")
        LAUNCHES["sta_gemm_skinny" + branch] += 1
    return y.reshape(*x.shape[:-1], n)
