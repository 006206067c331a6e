"""Plain PyTorch version of the dense GEMM kernels (the M-tiled
`sta_gemm` and the skinny `sta_gemm_skinny`): one product accumulated in
f32 (float operands) or exactly in int32 (int8 operands), then the
epilogue in its fixed order scale → bias → act. The CPU tests run it; on
the card it is the yardstick the CUDA kernels are held against."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import gemm_acc
from repro_torch.kernels.epilogue import (Epilogue, apply_epilogue,
                                          default_out_dtype)

__all__ = ["sta_gemm_ref"]


def sta_gemm_ref(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None, *, act: str = "none",
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``act(scale * (x @ w) + bias)`` for ``x [M, K]``, ``w [K, N]`` of
    x's dtype, accumulated in f32, or in int32 for int8 operands."""
    acc = gemm_acc(x, w)
    spec = Epilogue(act=act, has_bias=bias is not None,
                    has_scale=scale is not None)
    return apply_epilogue(acc, spec, out_dtype or default_out_dtype(
        x.dtype, spec), bias=bias, scale=scale)
