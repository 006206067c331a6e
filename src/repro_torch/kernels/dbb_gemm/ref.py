"""Plain PyTorch version of the DBB GEMM kernels (M-tiled and skinny):
decompress densely, multiply with an f32 accumulator (int32 for int8
activations on the INT8 values plane), apply the same epilogue. The CPU tests run it; on the card it is the yardstick the CUDA
kernels are held against."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dbb import (decompress_bitmask, dequantize_groups,
                                  unpack_nibbles)
from repro_torch.kernels.common import gemm_acc
from repro_torch.kernels.epilogue import (Epilogue, apply_epilogue,
                                          default_out_dtype)

__all__ = ["dbb_gemm_ref", "decompress_w4_ref"]


def decompress_w4_ref(values: torch.Tensor, bitmask: torch.Tensor,
                      gscale: torch.Tensor, *, block: int = 8,
                      group: int) -> torch.Tensor:
    """Dense f32 ``[K, N]`` from the nibble-packed INT4 plane
    ``values [K/B·k/2, N]``: sign-extend, bitmask-rank decompress, then
    dequantize with the groupwise ``gscale [K//G, N]``."""
    dense = decompress_bitmask(unpack_nibbles(values), bitmask, block=block)
    return dequantize_groups(dense, gscale, group)


def dbb_gemm_ref(x: torch.Tensor, values: torch.Tensor,
                 bitmask: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None, *, act: str = "none",
                 block: int = 8, out_dtype: Optional[torch.dtype] = None,
                 bits: int = 8, group: int = 0,
                 gscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(scale * (x @ unpack(values, bitmask)) + bias)`` for ``x [M, K]``:
    the decompressed weight is cast to x's dtype before the product (as
    the kernels round it), the product accumulates in f32, or exactly in
    int32 for int8 x. ``values`` is f32, int8 (exact in x's dtype; its
    scale is the epilogue's), or at ``bits=4`` the nibble plane,
    dequantized with ``gscale`` in f32 (one rounding) before the cast."""
    if bits == 4:
        w = decompress_w4_ref(values, bitmask, gscale, block=block,
                              group=group)
    else:
        w = decompress_bitmask(values, bitmask, block=block)
    acc = gemm_acc(x, w.to(x.dtype))
    spec = Epilogue(act=act, has_bias=bias is not None,
                    has_scale=scale is not None)
    return apply_epilogue(acc, spec, out_dtype or default_out_dtype(
        x.dtype, spec), bias=bias, scale=scale)
