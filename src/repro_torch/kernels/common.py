"""Shared kernel-wrapper utilities: the skinny-regime guard, epilogue
operand coercion, launch counters and argument checks.

Guards are stated for the H100, not carried over from the TPU's VMEM
budgets: the skinny kernels run a batch as chunks of 8 rows and stream
each chunk's activations through registers in K slices, so nothing of
size M·K has to stay resident.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["SKINNY_M_MAX", "skinny_ok", "coerce_bias_scale", "LAUNCHES",
           "reset_launches", "check_operand", "FLOAT_DTYPES"]

# Dispatch cap: decode / serving batches, as the reference's skinny rule.
# The kernels run M > 8 as ceil(M / 8) row chunks that share each weight
# slab in L2 (csrc/skinny_tile.cuh, csrc/dbb_gemm_skinny.cu).
SKINNY_M_MAX = 32

FLOAT_DTYPES = (torch.float32, torch.bfloat16)

# One plain integer per CUDA kernel: its wrapper adds one where it launches
# the kernel, and nowhere else (the CPU's plain path does not count).
# The DBB kernels count each values format apart (f32, ``_i8``, ``_w4``).
LAUNCHES: Dict[str, int] = {"dbb_gemm": 0, "dbb_gemm_skinny": 0,
                            "dbb_gemm_i8": 0, "dbb_gemm_skinny_i8": 0,
                            "dbb_gemm_w4": 0, "dbb_gemm_skinny_w4": 0,
                            "sta_gemm_skinny": 0, "paged_decode": 0,
                            "flash_prefill": 0, "flash_prefill_packed": 0,
                            "sta_gemm": 0, "conv_gemm": 0,
                            "conv_gemm_dbb": 0, "head_sample_fused": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def skinny_ok(m: int) -> bool:
    """Whether the skinny (weight-streaming, M ≤ 32) regime applies."""
    return 1 <= m <= SKINNY_M_MAX


def coerce_bias_scale(bias, scale, n: int, device
                      ) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """Epilogue rows are contiguous f32 ``[N]`` whatever dtype the caller's
    params are stored in; a scalar scale broadcasts."""
    def row(a):
        if a is None:
            return None
        a = torch.as_tensor(a, dtype=torch.float32, device=device)
        return a.reshape(-1).expand(n).contiguous() if a.numel() == 1 \
            else a.reshape(n).contiguous()
    return row(bias), row(scale)


def check_operand(name: str, t: torch.Tensor, shape: Tuple[int, ...],
                  dtypes: Tuple[torch.dtype, ...],
                  device: torch.device) -> None:
    """Raise unless ``t`` has this shape, one of these dtypes, lies on
    ``device`` and is contiguous — what the kernels' pointer arithmetic
    assumes."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
