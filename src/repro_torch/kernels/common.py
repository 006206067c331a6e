"""Shared kernel-wrapper utilities: the skinny-regime guard, epilogue
operand coercion, launch counters, argument and output-dtype checks, and
the plain versions' accumulator (f32, or exact int32 for int8 operands).

Guards are stated for the H100, not carried over from the TPU's VMEM
budgets: the skinny kernels run a batch as chunks of 8 rows and stream
each chunk's activations through registers in K slices, so nothing of
size M·K has to stay resident.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["SKINNY_M_MAX", "SMEM_LIMIT", "skinny_ok", "coerce_bias_scale", "LAUNCHES",
           "reset_launches", "check_operand", "FLOAT_DTYPES",
           "OPERAND_DTYPES", "INT8_OUT_DTYPES", "resolve_out_dtype",
           "gemm_acc"]

# Dispatch cap: decode / serving batches, as the reference's skinny rule.
# sta_gemm_skinny and dbb_gemm_skinny keep all M <= 32 rows in one block on
# every branch (csrc/sta_gemm_skinny.cu, csrc/dbb_gemm_skinny.cu, the int8
# branches' csrc/split_k_s8.cuh).
SKINNY_M_MAX = 32

# A block's dynamic shared memory on the H100: the opt-in per-block limit,
# 227 KB. The one Python spelling of it (csrc/common.cuh's kSmemLimit is
# the one C spelling); every guard and test reads it from here.
SMEM_LIMIT = 232448

FLOAT_DTYPES = (torch.float32, torch.bfloat16)
# operand dtypes of the GEMM and conv kernels: float, or the paper's INT8
# operands (int32 accumulator) on their int8 branches
OPERAND_DTYPES = FLOAT_DTYPES + (torch.int8,)
# outputs of an int8 branch: the raw int32 accumulator, f32 (dequantized
# by the scale), or int8 (requantized: round half to even, clip to ±127)
INT8_OUT_DTYPES = (torch.int32, torch.float32, torch.int8)

# One plain integer per CUDA kernel: its wrapper adds one where it launches
# the kernel, and nowhere else (the CPU's plain path does not count).
# The DBB kernels count each values format apart (f32, ``_i8``, ``_w4``);
# each int8-activation branch (``_s8``: INT8 x INT8 -> INT32) counts apart
# from its kernel's float branches. ``sta_gemm_tc`` and ``dbb_gemm_tc``
# count, beside those, the launches that ran the tensor-core body
# (csrc/tc_gemm.cuh): bf16 operands, by each wrapper's ``tc_body`` rule;
# ``flash_prefill_tc`` and ``flash_prefill_packed_tc`` those of the flash
# kernels' tensor-core body (csrc/flash_tc.cuh), by attn.ops.tc_body.
# ``sta_gemm_s8_tc`` and ``dbb_gemm_s8_tc`` count, beside ``sta_gemm_s8``
# and ``dbb_gemm_s8``, the int8 launches that ran the int8 tensor-core
# body (csrc/tc_gemm_s8.cuh), by each wrapper's ``s8_tc_body`` rule.
# ``dbb_gemm_narrow`` counts the dbb_gemm launches that ran the narrow
# split-K body (f32 x, N <= 16, by dbb_gemm.ops.narrow_body) and
# ``dbb_gemm_skinny_split`` the dbb_gemm_skinny launches that ran the
# split-K body (float x, by skinny.ops.split_body; csrc/split_k.cuh).
# ``conv_gemm_dbb_tc`` and ``conv_gemm_dbb_s8_tc`` count, beside
# ``conv_gemm_dbb`` and ``conv_gemm_dbb_s8``, the launches that ran the
# conv's tensor-core body (csrc/conv_tc.cuh), by conv_gemm.ops.tc_body;
# ``conv_gemm_tc`` and ``conv_gemm_s8_tc`` those of ``conv_gemm`` /
# ``conv_gemm_s8`` (the dense weight), ``conv_gemm_small`` and
# ``conv_gemm_s8_small`` those that ran conv_gemm's small-C body, by
# conv_gemm.ops.small_body (taken first).
LAUNCHES: Dict[str, int] = {"dbb_gemm": 0, "dbb_gemm_skinny": 0,
                            "dbb_gemm_i8": 0, "dbb_gemm_skinny_i8": 0,
                            "dbb_gemm_w4": 0, "dbb_gemm_skinny_w4": 0,
                            "sta_gemm_skinny": 0, "paged_decode": 0,
                            "flash_prefill": 0, "flash_prefill_packed": 0,
                            "sta_gemm": 0, "conv_gemm": 0,
                            "conv_gemm_dbb": 0, "head_sample_fused": 0,
                            "sta_gemm_s8": 0, "sta_gemm_skinny_s8": 0,
                            "dbb_gemm_s8": 0, "dbb_gemm_skinny_s8": 0,
                            "conv_gemm_s8": 0, "conv_gemm_dbb_s8": 0,
                            "sta_gemm_tc": 0, "dbb_gemm_tc": 0,
                            "flash_prefill_tc": 0,
                            "flash_prefill_packed_tc": 0,
                            "dbb_gemm_narrow": 0,
                            "dbb_gemm_skinny_split": 0,
                            "sta_gemm_s8_tc": 0, "dbb_gemm_s8_tc": 0,
                            "conv_gemm_dbb_tc": 0,
                            "conv_gemm_dbb_s8_tc": 0,
                            "conv_gemm_tc": 0, "conv_gemm_s8_tc": 0,
                            "conv_gemm_small": 0, "conv_gemm_s8_small": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def skinny_ok(m: int) -> bool:
    """Whether the skinny (weight-streaming, M ≤ 32) regime applies."""
    return 1 <= m <= SKINNY_M_MAX


def resolve_out_dtype(x_dtype: torch.dtype, out_dtype: Optional[torch.dtype],
                      has_scale: bool,
                      float_outs: Optional[Tuple[torch.dtype, ...]] = None
                      ) -> torch.dtype:
    """The output dtype a kernel stores, or TypeError. int8 operands: int32
    by default, f32 when a scale is fused (the reference's
    ``default_out_dtype``), or any of INT8_OUT_DTYPES asked for; float
    operands: x's dtype, or one of ``float_outs`` (default: x's only)."""
    if x_dtype == torch.int8:
        od = out_dtype or (torch.float32 if has_scale else torch.int32)
        allowed = INT8_OUT_DTYPES
    else:
        od = out_dtype or x_dtype
        allowed = float_outs or (x_dtype,)
    if od not in allowed:
        raise TypeError(f"out_dtype {od} for {x_dtype} operands: the kernel "
                        f"stores one of {allowed}")
    return od


def gemm_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain versions' accumulator of ``x @ w``: f32 for float
    operands; for int8 operands the exact int32 sum, taken in f64 (every
    sum of int8 products below 2^53 is exact there, far past olmo's
    K·127² ≈ 1.3e8) and cast. Not int8 ``torch.matmul``: on the CPU it
    returns int8 and wraps, and CUDA has none."""
    if x.dtype == torch.int8:
        return torch.matmul(x.to(torch.float64),
                            w.to(torch.float64)).to(torch.int32)
    return torch.matmul(x.float(), w.float())


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
