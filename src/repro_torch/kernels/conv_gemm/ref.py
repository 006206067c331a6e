"""Plain PyTorch versions of the implicit-GEMM conv kernels: the explicit
lowering the kernels replace — build the im2col patch matrix, multiply it
with the (decompressed) weight in f32 (exactly in int32 for an int8
image), apply the same epilogue. The CPU
tests run them; the plain conv route (``conv_xla``) is them; on the card
they are the yardstick the CUDA kernels are held against.

`im2col` keeps the reference's K order — spatial-major (i·kw + j), then
channel — so the weight matrix ``[kh·kw·C, N]`` is the same in every
route and DBB blocks of 8 run along it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.dbb import decompress_bitmask
from repro_torch.kernels.common import gemm_acc
from repro_torch.kernels.epilogue import (Epilogue, apply_epilogue,
                                          default_out_dtype)

__all__ = ["out_spatial", "im2col", "conv_gemm_ref", "conv_gemm_dbb_ref"]


def out_spatial(size: int, k: int, stride: int, padding: str
                ) -> tuple:
    """(out, pad_lo, pad_hi) of one spatial dim, XLA's SAME/VALID rules:
    SAME pads ``total = max((out - 1)·stride + k - size, 0)`` with
    ``lo = total // 2`` before and the rest after."""
    if padding == "VALID":
        return max(0, (size - k) // stride + 1), 0, 0
    if padding != "SAME":
        raise ValueError(f"padding={padding!r} not in ('SAME', 'VALID')")
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, total // 2, total - total // 2


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """x [B, H, W, C] → patches [B, Ho, Wo, kh·kw·C], K index
    (i·kw + j)·C + c."""
    b, h, w, c = x.shape
    ho, pt, pb = out_spatial(h, kh, stride, padding)
    wo, pl, pr = out_spatial(w, kw, stride, padding)
    if ho == 0 or wo == 0:      # VALID with a window larger than the image
        return x.new_zeros((b, ho, wo, kh * kw * c))
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    # [B, Ho', Wo', C, kh, kw] windows; VALID leftovers are cut to Ho, Wo
    win = xp.unfold(1, kh, stride).unfold(2, kw, stride)[:, :ho, :wo]
    return win.permute(0, 1, 2, 4, 5, 3).reshape(b, ho, wo, kh * kw * c)


def conv_gemm_ref(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None, *, kh: int, kw: int,
                  stride: int = 1, padding: str = "SAME", act: str = "none",
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Explicit im2col + GEMM: ``[B, H, W, C] × [kh·kw·C, N] →
    [B, Ho, Wo, N]``, the weight cast to x's dtype, accumulated in f32,
    or exactly in int32 for int8 operands."""
    cols = im2col(x, kh, kw, stride, padding)
    b, ho, wo, kdim = cols.shape
    acc = gemm_acc(cols.reshape(-1, kdim), w.to(x.dtype))
    spec = Epilogue(act=act, has_bias=bias is not None,
                    has_scale=scale is not None)
    y = apply_epilogue(acc, spec, out_dtype or default_out_dtype(
        x.dtype, spec), bias=bias, scale=scale)
    return y.reshape(b, ho, wo, w.shape[1])


def conv_gemm_dbb_ref(x: torch.Tensor, values: torch.Tensor,
                      bitmask: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      scale: Optional[torch.Tensor] = None, *, kh: int,
                      kw: int, stride: int = 1, padding: str = "SAME",
                      act: str = "none", block: int = 8,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """The DBB weight decompressed densely, then `conv_gemm_ref`."""
    w = decompress_bitmask(values, bitmask, block=block)
    return conv_gemm_ref(x, w, bias, scale, kh=kh, kw=kw, stride=stride,
                         padding=padding, act=act, out_dtype=out_dtype)
