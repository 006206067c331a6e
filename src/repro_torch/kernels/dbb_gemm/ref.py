"""Plain PyTorch version of the DBB GEMM kernels (M-tiled and skinny):
decompress densely, multiply with an f32 accumulator, apply the same
epilogue. The CPU tests run it; on the card it is the yardstick the CUDA
kernels are held against."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dbb import decompress_bitmask
from repro_torch.kernels.epilogue import (Epilogue, apply_epilogue,
                                          default_out_dtype)

__all__ = ["dbb_gemm_ref"]


def dbb_gemm_ref(x: torch.Tensor, values: torch.Tensor,
                 bitmask: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None, *, act: str = "none",
                 block: int = 8, out_dtype: Optional[torch.dtype] = None
                 ) -> torch.Tensor:
    """``act(scale * (x @ unpack(values, bitmask)) + bias)`` for ``x [M, K]``:
    the decompressed weight is cast to x's dtype before the product (as
    the kernels round it), the product accumulates in f32."""
    w = decompress_bitmask(values, bitmask, block=block).to(x.dtype)
    acc = torch.matmul(x.float(), w.float())
    spec = Epilogue(act=act, has_bias=bias is not None,
                    has_scale=scale is not None)
    return apply_epilogue(acc, spec, out_dtype or default_out_dtype(
        x.dtype, spec), bias=bias, scale=scale)
