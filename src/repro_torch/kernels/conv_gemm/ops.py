"""Wrappers of the implicit-GEMM conv kernels: `conv_gemm`
(csrc/conv_gemm.cu) takes a dense weight ``[kh·kw·C, N]``,
`conv_gemm_dbb` (csrc/conv_gemm_dbb.cu) the DBB planes, and
`conv_gemm_packed` a `DbbWeight` with its per-channel scale in the
epilogue — one for one with the reference's wrappers.

An int8 image takes each kernel's int8 branch (``conv_gemm_s8``,
``conv_gemm_dbb_s8`` on the INT8 values plane: INT8 × INT8 → INT32,
stored as int32 by default, f32 with a scale, or int8 requantized). On a
CUDA tensor each launches its kernel (or raises); on a CPU tensor it
runs the plain version (explicit im2col + one product). The kernels read
the unpadded NHWC image and treat positions outside it as zero (SAME
padding, XLA's ``lo = total // 2``); output rows and channels past Ho, Wo
and N are masked in the store. Nothing is padded or copied, and their
shared memory does not grow with the image, so no image size is refused
for lack of it.

`conv_gemm_dbb` runs f32 and int8 images whose geometry `tc_body` admits
(convnet's conv1 and conv2 among them) on its tensor-core body
(csrc/conv_tc.cuh: TMA im2col boxes, the DBB planes decompressed in
shared memory, 3xTF32 / s8 wgmma), counted as ``conv_gemm_dbb_tc`` /
``conv_gemm_dbb_s8_tc`` beside the branch; the rest on the FMA body. The
tensor-core body's TMA copies need 16-byte rows: x's channels (C·esz) and
the planes' N (N·4 for f32 values and the bitmask, N for int8 values);
the rule asks for more (whole 64-byte channel pieces, N % 16 for int8)
and the wrappers check 16-byte aligned, contiguous operands.

`conv_gemm` picks one of three bodies (csrc/conv_gemm.cu): f32 and int8
images with a small K = kh·kw·C and N (`small_body`: convnet's conv0,
lenet's conv1) run the small-C body (the whole filter and a tile's
zero-halo image window in shared memory, all N channels a block), counted as
``conv_gemm_small`` / ``conv_gemm_s8_small``; else images that `tc_body`
admits (convnet's dense conv1 and conv2) run the tensor-core body on the
dense weight, counted as ``conv_gemm_tc`` / ``conv_gemm_s8_tc``; the rest
the FMA body.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.dbb import DbbWeight
from repro_torch.kernels import build
from repro_torch.kernels.common import (LAUNCHES, OPERAND_DTYPES,
                                        check_operand, coerce_bias_scale,
                                        resolve_out_dtype)
from repro_torch.kernels.conv_gemm.ref import (conv_gemm_dbb_ref,
                                               conv_gemm_ref, out_spatial)
from repro_torch.kernels.epilogue import ACT_CODES

__all__ = ["conv_gemm", "conv_gemm_dbb", "conv_gemm_packed", "out_spatial",
           "tc_body", "small_body", "SMALL_K", "SMALL_N"]

_INT_MAX = 2 ** 31 - 1     # the kernels index pixels and channels in int
SMALL_K = 160   # csrc/conv_gemm.cu kSmallK: the largest kh·kw·C it stages
SMALL_N = 64    # kSmallN: 8 channel lanes of 8 channels


def tc_body(dtype: torch.dtype, c: int, kh: int, kw: int, stride: int,
            n: int) -> bool:
    """Whether `conv_gemm_dbb` runs an image of this dtype and geometry on
    its tensor-core body: f32 with C % 16 == 0 and N % 4 == 0, or int8 with
    C % 64 == 0 and N % 16 == 0 (a stage's 64-byte pieces of channels; the
    16-byte rows TMA copies the planes by), kh, kw <= 32 and stride <= 8
    (the im2col map's corner and traversal-stride ranges). The rule of
    csrc/conv_gemm_dbb.cu's tc_body; it reads no B, H or W, and takes no
    bf16 image."""
    return (((dtype == torch.float32 and c % 16 == 0 and n % 4 == 0)
             or (dtype == torch.int8 and c % 64 == 0 and n % 16 == 0))
            and kh <= 32 and kw <= 32 and stride <= 8)


def small_body(dtype: torch.dtype, c: int, kh: int, kw: int, n: int
               ) -> bool:
    """Whether `conv_gemm` runs an image of this dtype and geometry on its
    small-C body: f32 or int8 with kh·kw·C <= SMALL_K and N <= SMALL_N. The
    rule of csrc/conv_gemm.cu's small_body, taken before `tc_body`; it
    reads no B, H, W or stride, and takes no bf16 image."""
    return (dtype in (torch.float32, torch.int8) and kh * kw * c <= SMALL_K
            and n <= SMALL_N)


def _geometry(x: torch.Tensor, kh: int, kw: int, stride: int, padding: str
              ) -> Tuple[int, ...]:
    """Validate x and return the launchers' geometry (B, H, W, C, Ho, Wo,
    kh, kw, stride, pad_top, pad_left)."""
    if x.ndim != 4:
        raise ValueError(f"x {tuple(x.shape)}: expected NHWC [B, H, W, C]")
    b, h, w, c = x.shape
    ho, pt, _ = out_spatial(h, kh, stride, padding)
    wo, pl, _ = out_spatial(w, kw, stride, padding)
    check_operand("x", x, (b, h, w, c), OPERAND_DTYPES, x.device)
    if b * ho * wo > _INT_MAX or x.numel() > _INT_MAX:
        raise ValueError(f"x {tuple(x.shape)}: over 2^31 pixels or values")
    return b, h, w, c, ho, wo, kh, kw, stride, pt, pl


def _empty(geom, n: int) -> bool:
    """An empty output (no grid to launch): B·Ho·Wo·N == 0."""
    b, _, _, _, ho, wo = geom[:6]
    return b * ho * wo * n == 0


def _run(name: str, args, geom, n: int, tail, x: torch.Tensor,
         out_dtype: torch.dtype) -> torch.Tensor:
    """Launch conv kernel ``name`` on the current stream, on its float
    branch (x's dtype code) or, for an int8 image, its ``_s8`` branch (the
    out dtype code); count it under the branch's name."""
    b, _, _, _, ho, wo = geom[:6]
    branch = name + ("_s8" if x.dtype == torch.int8 else "")
    out = torch.empty((b, ho, wo, n), dtype=out_dtype, device=x.device)
    if x.device.type == "meta":
        return out
    fn = getattr(build.load(name), f"{branch}_launch")
    fn.argtypes = ([ctypes.c_void_p] * (len(args) + 1)
                   + [ctypes.c_int] * (len(geom) + 1 + len(tail) + 1)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    code = out_dtype if branch != name else x.dtype
    rc = fn(*args, out.data_ptr(), *geom, n, *tail, build.dtype_code(code),
            build.stream_handle(x.device))
    if rc != 0:
        raise RuntimeError(f"{branch} launch failed: cudaError {rc}")
    LAUNCHES[branch] += 1
    return out


def conv_gemm(x: torch.Tensor, w: torch.Tensor, bias=None, scale=None, *,
              kh: int, kw: int, stride: int = 1, padding: str = "SAME",
              act: str = "none", out_dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """``act(scale · conv2d(x, w) + bias)``: x ``[B, H, W, C]`` NHWC, w the
    explicit lowering's ``[kh·kw·C, N]`` in x's dtype → ``[B, Ho, Wo, N]``
    in x's dtype (float x) or ``out_dtype`` (int8 x)."""
    geom = _geometry(x, kh, kw, stride, padding)
    out_dtype = resolve_out_dtype(x.dtype, out_dtype, scale is not None)
    k_dim, n = kh * kw * x.shape[-1], w.shape[-1]
    check_operand("w", w, (k_dim, n), (x.dtype,), x.device)
    bias, scale = coerce_bias_scale(bias, scale, n, x.device)
    if x.device.type == "cpu" or _empty(geom, n):
        return conv_gemm_ref(x, w, bias, scale, kh=kh, kw=kw, stride=stride,
                             padding=padding, act=act, out_dtype=out_dtype)
    y = _run("conv_gemm", (x.data_ptr(), w.data_ptr(), build.ptr(scale),
                           build.ptr(bias)),
             geom, n, (ACT_CODES[act],), x, out_dtype)
    if x.device.type == "meta":
        return y
    c = x.shape[-1]
    branch = "conv_gemm" + ("_s8" if x.dtype == torch.int8 else "")
    if small_body(x.dtype, c, kh, kw, n):
        LAUNCHES[branch + "_small"] += 1
    elif tc_body(x.dtype, c, kh, kw, stride, n):
        LAUNCHES[branch + "_tc"] += 1
    return y


def conv_gemm_dbb(x: torch.Tensor, values: torch.Tensor,
                  bitmask: torch.Tensor, bias=None, scale=None, *, kh: int,
                  kw: int, stride: int = 1, padding: str = "SAME",
                  act: str = "none", block: int = 8, nnz: int = 4,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`conv_gemm` against the DBB planes ``values [K/8·nnz, N]`` (f32 for
    a float image, int8 for an int8 one) and ``bitmask [K/8, N]`` (int32),
    K = kh·kw·C. The kernel takes B = 8 and kw·C % 8 == 0, so each kernel
    row covers whole DBB blocks."""
    geom = _geometry(x, kh, kw, stride, padding)
    out_dtype = resolve_out_dtype(x.dtype, out_dtype, scale is not None)
    c = x.shape[-1]
    k_dim, n = kh * kw * c, values.shape[-1]
    if block != 8:
        raise ValueError(f"DBB block {block}: the kernel takes B = 8")
    if not 1 <= nnz <= 8:
        raise ValueError(f"nnz={nnz} outside [1, 8]")
    if (kw * c) % block:
        raise ValueError(f"kw·C = {kw * c} not a multiple of the DBB block "
                         f"{block}")
    check_operand("values", values, (k_dim // block * nnz, n),
                  (torch.int8 if x.dtype == torch.int8 else torch.float32,),
                  x.device)
    check_operand("bitmask", bitmask, (k_dim // block, n), (torch.int32,),
                  x.device)
    bias, scale = coerce_bias_scale(bias, scale, n, x.device)
    if x.device.type == "cpu" or _empty(geom, n):
        return conv_gemm_dbb_ref(x, values, bitmask, bias, scale, kh=kh,
                                 kw=kw, stride=stride, padding=padding,
                                 act=act, block=block, out_dtype=out_dtype)
    y = _run("conv_gemm_dbb", (x.data_ptr(), values.data_ptr(),
                               bitmask.data_ptr(), build.ptr(scale),
                               build.ptr(bias)),
             geom, n, (nnz, ACT_CODES[act]), x, out_dtype)
    if x.device.type != "meta" and tc_body(x.dtype, c, kh, kw, stride, n):
        LAUNCHES["conv_gemm_dbb" + ("_s8" if x.dtype == torch.int8 else "")
                 + "_tc"] += 1
    return y


def conv_gemm_packed(x: torch.Tensor, p: DbbWeight, bias=None, *, kh: int,
                     kw: int, stride: int = 1, padding: str = "SAME",
                     act: str = "none",
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`conv_gemm_dbb` on a 2-D `DbbWeight` (``k_dim = kh·kw·C``); its
    per-channel scale, if any, runs in the epilogue."""
    if p.bits != 8:
        raise NotImplementedError(
            f"bits={p.bits}: the conv kernels take the bits=8 plane only "
            "(w4 is not ported)")
    if p.k_dim != kh * kw * x.shape[-1]:
        raise ValueError(f"packed K={p.k_dim} against kh·kw·C = "
                         f"{kh * kw * x.shape[-1]}")
    return conv_gemm_dbb(x, p.values, p.bitmask, bias, p.scale, kh=kh,
                         kw=kw, stride=stride, padding=padding, act=act,
                         block=p.block, nnz=p.nnz, out_dtype=out_dtype)
