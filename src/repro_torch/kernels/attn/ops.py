"""Wrappers of the attention kernels: causal flash prefill
(csrc/flash_prefill.cu), packed block-diagonal flash prefill
(csrc/flash_prefill_packed.cu) and paged decode (csrc/paged_decode.cu).

Each takes the model layout the JAX package's wrappers take. A CPU tensor
runs the plain version (`ref`); a CUDA tensor launches the kernel or
raises. The prefill kernels read q/k/v through strides in the model layout
and mask their ragged edges, so neither wrapper transposes or pads.

The two prefill kernels have two bodies each, by `tc_body`'s rule on
(dtype, D) and never on B, T, S or the segments: bf16 with D a multiple of
64 and at most 128 runs on the tensor-core body (csrc/flash_tc.cuh: TMA,
wgmma) and counts as ``flash_prefill_tc`` / ``flash_prefill_packed_tc``
too; f32, and bf16 at any other D, run the plain-FMA body
(csrc/flash_tile.cuh).

A contiguous ``[B, S, Hkv, D]`` decode cache is served by the same decode
wrapper as the pool ``[B · S/page, page, Hkv, D]`` (a view, no copy) under
an identity block table — one kernel, one page-visit order for both
layouts.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attn.ref import (flash_prefill_ref,
                                          packed_prefill_ref,
                                          paged_decode_ref)
from repro_torch.kernels.common import FLOAT_DTYPES, LAUNCHES, check_operand

__all__ = ["flash_attention", "packed_flash_attention",
           "paged_decode_attention", "identity_block_table", "DEFAULT_PAGE",
           "flash_ok", "paged_decode_ok", "PAGE_MIN", "SMEM_LIMIT",
           "FLASH_D_MAX", "tc_body"]

# default KV page (slots) when the config leaves kv_page_size unset
DEFAULT_PAGE = 64
# smallest page the decode route takes: one warp scores a key at a time,
# so pages under 8 slots leave the block's warps mostly idle per page
PAGE_MIN = 8
# a block's shared memory on the H100 (227 KB usable)
SMEM_LIMIT = 232448
# flash prefill tiles (csrc/flash_tile.cuh, csrc/flash_tc.cuh): 64 query
# rows x 64 keys; the FMA body has 16 output columns a thread
_FLASH_BQ = _FLASH_BKV = 64
FLASH_D_MAX = 128
# the tensor-core body's K/V ring and barriers (q_full; k_full, v_full and
# empty per stage)
_FLASH_TC_STAGES = 2
_FLASH_TC_BARRIERS = 1 + 3 * _FLASH_TC_STAGES


def tc_body(dtype: torch.dtype, d: int) -> bool:
    """Whether the flash prefill kernels run these operands on their
    tensor-core body: bf16 with D a multiple of 64 and at most 128. The
    rule of csrc/flash_prefill.cu's and flash_prefill_packed.cu's tc_body;
    it reads no B, T, S or segment."""
    return dtype == torch.bfloat16 and d > 0 and d % 64 == 0 and d <= 128


def _flash_smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Shared memory of one flash prefill block of the body ``dtype`` and
    ``d`` take. Tensor cores (flash_tc.cuh, smem_bytes): bf16 Q [64, D],
    two stages of K and V [64, D], the barriers and 1024 bytes of
    alignment slack. FMA (flash_tile.cuh, smem_bytes): Qᵀ [D, 65], Kᵀ [D,
    65] (later P [64, 65]) and V [64, D], all f32."""
    if tc_body(dtype, d):
        return (2 * d * (_FLASH_BQ + 2 * _FLASH_TC_STAGES * _FLASH_BKV)
                + 8 * _FLASH_TC_BARRIERS + 1024)
    return 4 * (d * (_FLASH_BQ + 1) + max(d, _FLASH_BQ) * (_FLASH_BKV + 1)
                + _FLASH_BKV * d)


def flash_ok(d: int, dtype: Optional[torch.dtype] = None) -> bool:
    """Whether the flash prefill kernels take head dim ``d`` in ``dtype``
    (every float dtype when None): at most 128 output columns and the
    block's tiles, in the body the call takes, within 227 KB."""
    dtypes = FLOAT_DTYPES if dtype is None else (dtype,)
    return 1 <= d <= FLASH_D_MAX and all(
        _flash_smem_bytes(d, dt) <= SMEM_LIMIT for dt in dtypes)


def _decode_smem_bytes(g: int, d: int, page: int) -> int:
    """Shared memory of one decode block: q and acc [G, D], the page's
    scores [G, page] and three [G] running statistics, all f32."""
    return 4 * (2 * g * d + g * page + 3 * g)


def paged_decode_ok(group: int, page: int, d: int) -> bool:
    """Whether the decode kernel's shared memory fits one block."""
    return _decode_smem_bytes(group, d, page) <= SMEM_LIMIT


def identity_block_table(b: int, n_log: int,
                         device: torch.device) -> torch.Tensor:
    """Row ``b``'s logical page ``j`` → physical page ``b * n_log + j``."""
    return (torch.arange(b, dtype=torch.int32, device=device)[:, None] * n_log
            + torch.arange(n_log, dtype=torch.int32, device=device)[None, :])


def _bind(name: str, n_ptr: int, n_int: int):
    """The C launcher ``<name>_launch``: n_ptr pointers, n_int ints, then
    (sm_scale, window, softcap, dtype, stream)."""
    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _check_flash(q: torch.Tensor, hkv: int) -> None:
    d, hq = q.shape[-1], q.shape[-2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if q.device.type != "cpu" and not flash_ok(d, q.dtype):
        raise ValueError(f"D={d}: the flash kernels take 1 ≤ D ≤ "
                         f"{FLASH_D_MAX} (shared memory "
                         f"{_flash_smem_bytes(d, q.dtype)} B of "
                         f"{SMEM_LIMIT})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    start: Optional[torch.Tensor] = None, *,
                    q_offset: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Causal flash attention, model layout in and out: ``q [B, T, Hq,
    D]``, ``k/v [B, S, Hkv, D]`` → ``o [B, T, Hq, D]`` in q's dtype.

    ``start`` [B]: first real key slot of a left-padded row (query rows
    below it are garbage the caller ignores). ``q_offset`` [B]: absolute
    slot of query row 0 — a chunked-prefill continuation attends S cache
    slots with T chunk rows; 0 by default."""
    b, t, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dev = q.device
    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    start = zeros if start is None else start.reshape(b)
    q_offset = zeros if q_offset is None else q_offset.reshape(b)
    check_operand("q", q, (b, t, hq, d), FLOAT_DTYPES, dev)
    check_operand("k", k, (b, s_len, hkv, d), (q.dtype,), dev)
    check_operand("v", v, (b, s_len, hkv, d), (q.dtype,), dev)
    check_operand("start", start, (b,), (torch.int32,), dev)
    check_operand("q_offset", q_offset, (b,), (torch.int32,), dev)
    _check_flash(q, hkv)
    if dev.type == "cpu":
        o = flash_prefill_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), start, q_offset,
                              sm_scale=sm_scale, window=window,
                              softcap=softcap)
        return o.transpose(1, 2).contiguous()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    rc = _bind("flash_prefill", 6, 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), start.data_ptr(),
        q_offset.data_ptr(), out.data_ptr(), b, t, s_len, hq, hkv, d,
        float(sm_scale), int(window), float(softcap),
        build.dtype_code(q.dtype), build.stream_handle(dev))
    _check_rc("flash_prefill", rc)
    LAUNCHES["flash_prefill"] += 1
    if tc_body(q.dtype, d):
        LAUNCHES["flash_prefill_tc"] += 1
    return out


def packed_flash_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, seg_ids: torch.Tensor, *,
                           sm_scale: Optional[float] = None, window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """Block-diagonal causal flash attention over a packed ragged batch:
    ``q [T, Hq, D]``, ``k/v [T, Hkv, D]``, ``seg_ids [T]`` int32
    (non-decreasing; the owning request of each packed position) → ``o
    [T, Hq, D]`` in q's dtype. No query attends another segment's key;
    rows that see no key hold finite values the caller never reads. (The
    reference pads T up to its block with segment id ``2**30``; this
    kernel masks its ragged edge, so no such rows exist.)"""
    t, hq, d = q.shape
    hkv = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dev = q.device
    check_operand("q", q, (t, hq, d), FLOAT_DTYPES, dev)
    check_operand("k", k, (t, hkv, d), (q.dtype,), dev)
    check_operand("v", v, (t, hkv, d), (q.dtype,), dev)
    check_operand("seg_ids", seg_ids, (t,), (torch.int32,), dev)
    _check_flash(q, hkv)
    if dev.type == "cpu":
        o = packed_prefill_ref(q.transpose(0, 1), k.transpose(0, 1),
                               v.transpose(0, 1), seg_ids,
                               sm_scale=sm_scale, window=window,
                               softcap=softcap)
        return o.transpose(0, 1).contiguous()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    rc = _bind("flash_prefill_packed", 5, 4)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ids.data_ptr(),
        out.data_ptr(), t, hq, hkv, d, float(sm_scale), int(window),
        float(softcap), build.dtype_code(q.dtype), build.stream_handle(dev))
    _check_rc("flash_prefill_packed", rc)
    LAUNCHES["flash_prefill_packed"] += 1
    if tc_body(q.dtype, d):
        LAUNCHES["flash_prefill_packed_tc"] += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor,
                           start: Optional[torch.Tensor] = None, *,
                           sm_scale: Optional[float] = None, window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """One-token decode: ``q [B, Hkv, G, D]`` against the pool
    ``[P, page, Hkv, D]`` through ``block_table [B, n_log]``; ``lengths``
    [B] is the new token's slot (already written), ``start`` [B] the first
    real slot. Returns ``o [B, Hkv, G, D]`` in q's dtype."""
    b, hkv, g, d = q.shape
    p_total, page = k_pages.shape[:2]
    n_log = block_table.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dev = q.device
    if start is None:
        start = torch.zeros((b,), dtype=torch.int32, device=dev)
    check_operand("q", q, (b, hkv, g, d), FLOAT_DTYPES, dev)
    check_operand("k_pages", k_pages, (p_total, page, hkv, d), (q.dtype,), dev)
    check_operand("v_pages", v_pages, (p_total, page, hkv, d), (q.dtype,), dev)
    check_operand("block_table", block_table, (b, n_log), (torch.int32,), dev)
    check_operand("lengths", lengths, (b,), (torch.int32,), dev)
    check_operand("start", start, (b,), (torch.int32,), dev)
    if dev.type == "cpu":
        return paged_decode_ref(q, k_pages, v_pages, block_table, lengths,
                                start, sm_scale=sm_scale, window=window,
                                softcap=softcap)
    if not paged_decode_ok(g, page, d):
        raise ValueError(f"G={g}, page={page}, D={d}: shared memory "
                         f"{_decode_smem_bytes(g, d, page)} B over "
                         f"{SMEM_LIMIT}")
    out = torch.empty_like(q)
    rc = _bind("paged_decode", 7, 6)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), start.data_ptr(),
        out.data_ptr(), b, hkv, g, d, page, n_log, float(sm_scale),
        int(window), float(softcap), build.dtype_code(q.dtype),
        build.stream_handle(dev))
    _check_rc("paged_decode", rc)
    LAUNCHES["paged_decode"] += 1
    return out
