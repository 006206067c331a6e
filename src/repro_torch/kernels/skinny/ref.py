"""Plain PyTorch versions of the skinny (M ≤ 32) kernels. The DBB variant
computes the same function as the M-tiled DBB GEMM, so it shares
`dbb_gemm_ref`; the dense variant is `sta_gemm_ref`."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.dbb_gemm.ref import dbb_gemm_ref
from repro_torch.kernels.epilogue import (Epilogue, apply_epilogue,
                                          default_out_dtype)

__all__ = ["sta_gemm_ref", "dbb_gemm_ref"]


def sta_gemm_ref(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None, *, act: str = "none",
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``act(scale * (x @ w) + bias)`` for ``x [M, K]``, ``w [K, N]`` of
    x's dtype, accumulated in f32."""
    acc = torch.matmul(x.float(), w.float())
    spec = Epilogue(act=act, has_bias=bias is not None,
                    has_scale=scale is not None)
    return apply_epilogue(acc, spec, out_dtype or default_out_dtype(
        x.dtype, spec), bias=bias, scale=scale)
