"""Wrappers of the attention kernels: causal flash prefill
(csrc/flash_prefill.cu), packed block-diagonal flash prefill
(csrc/flash_prefill_packed.cu) and paged decode (csrc/paged_decode.cu).

Each takes the model layout the JAX package's wrappers take. A CPU tensor
runs the plain version (`ref`); a CUDA tensor launches the kernel or
raises. The prefill kernels read q/k/v through strides in the model layout
and mask their ragged edges, so neither wrapper transposes or pads.

The two prefill kernels have two bodies each, by `tc_body`'s rule on
(dtype, D) and never on B, T, S or the segments: bf16 with D 64, 128 or
256 runs on the tensor-core body (csrc/flash_tc.cuh: TMA, wgmma; D 256 on
two consumer warpgroups) and counts as ``flash_prefill_tc`` /
``flash_prefill_packed_tc`` too; f32, and bf16 at any other D, run the
plain-FMA body (csrc/flash_tile.cuh). Both take D up to 256, as the
reference's flash kernels take paligemma's head dim 256.

A contiguous ``[B, S, Hkv, D]`` decode cache is served by the same decode
wrapper as the pool ``[B · S/page, page, Hkv, D]`` (a view, no copy) under
an identity block table — one kernel, one split of each row's pages for
both layouts. The decode kernel splits a row's live pages across blocks
(`decode_splits`) and merges the splits in a second launch from a
workspace the wrapper allocates per call.
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
from repro_torch.kernels.common import (FLOAT_DTYPES, LAUNCHES, SMEM_LIMIT,
                                        check_operand)

__all__ = ["flash_attention", "packed_flash_attention",
           "paged_decode_attention", "identity_block_table", "DEFAULT_PAGE",
           "flash_ok", "paged_decode_ok", "PAGE_MIN", "SMEM_LIMIT",
           "FLASH_D_MAX", "tc_body", "split_pages", "decode_splits",
           "decode_workspace_elems"]

# default KV page (slots) when the config leaves kv_page_size unset
DEFAULT_PAGE = 64
# smallest page the decode kernel takes (csrc/paged_decode.cu, kPageMin): a
# split's 64 keys then span at most 8 pages, 8 table lookups
PAGE_MIN = 8
# the decode kernel (csrc/paged_decode.cu): a split holds
# max(1, _DECODE_SPLIT_KEYS // page) pages, a block stages up to
# _DECODE_CHUNK keys with its 4 warps, D is a multiple of 8 and at most 256
_DECODE_SPLIT_KEYS = _DECODE_CHUNK = 64
_DECODE_WARPS = 4
_DECODE_D_ALIGN, _DECODE_D_MAX = 8, 256
_DECODE_K_PAD = 32
# flash prefill tiles (csrc/flash_tile.cuh, csrc/flash_tc.cuh): 64 query
# rows x 64 keys; the FMA body has 16 output columns a thread up to D 128
# and 32 up to D 256 (kDMax), the tensor-core body splits D 256 over two
# consumer warpgroups
_FLASH_BQ = _FLASH_BKV = 64
FLASH_D_MAX = 256
# the tensor-core body's K/V ring and barriers (q_full; k_full, v_full and
# empty per stage)
_FLASH_TC_STAGES = 2
_FLASH_TC_BARRIERS = 1 + 3 * _FLASH_TC_STAGES


def tc_body(dtype: torch.dtype, d: int) -> bool:
    """Whether the flash prefill kernels run these operands on their
    tensor-core body: bf16 with D 64, 128 or 256. The rule of
    csrc/flash_prefill.cu's and flash_prefill_packed.cu's tc_body; it
    reads no B, T, S or segment."""
    return dtype == torch.bfloat16 and d in (64, 128, 256)


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
    (every float dtype when None): at most FLASH_D_MAX (256) output
    columns and the block's tiles, in the body the call takes, within 227
    KB."""
    dtypes = FLOAT_DTYPES if dtype is None else (dtype,)
    return 1 <= d <= FLASH_D_MAX and all(
        _flash_smem_bytes(d, dt) <= SMEM_LIMIT for dt in dtypes)


def _decode_smem_bytes(g: int, d: int, itemsize: int) -> int:
    """Shared memory of one decode split block (csrc/paged_decode.cu,
    smem_bytes): q, acc [G, D], the four warps' P·V partials [4, G, D],
    the chunk's scores [G, 64] and four [G] statistics, all f32; the
    chunk's 64 K rows (D · itemsize + 32 bytes each) and V rows."""
    return (4 * ((2 + _DECODE_WARPS) * g * d + _DECODE_CHUNK * g + 4 * g)
            + _DECODE_CHUNK * (2 * d * itemsize + _DECODE_K_PAD))


def paged_decode_ok(group: int, page: int, d: int,
                    dtype: Optional[torch.dtype] = None) -> bool:
    """Whether the decode kernel takes these operands (every float dtype
    when ``dtype`` is None): a page of at least PAGE_MIN slots, D a
    multiple of 8 and at most 256, and a split block's shared memory
    within 227 KB."""
    dtypes = FLOAT_DTYPES if dtype is None else (dtype,)
    return (page >= PAGE_MIN and d % _DECODE_D_ALIGN == 0
            and 0 < d <= _DECODE_D_MAX
            and all(_decode_smem_bytes(group, d, dt.itemsize) <= SMEM_LIMIT
                    for dt in dtypes))


def split_pages(page: int) -> int:
    """Logical pages a decode split owns: a rule on the page size alone
    (csrc/paged_decode.cu, split_pages)."""
    return 1 if page >= _DECODE_SPLIT_KEYS else _DECODE_SPLIT_KEYS // page


def decode_splits(n_log: int, page: int) -> int:
    """The decode workspace's splits per (row, KV head) for a table n_log
    pages wide: every split any row of it can have (csrc/paged_decode.cu,
    max_splits)."""
    return -(-n_log // split_pages(page))


def decode_workspace_elems(b: int, hkv: int, g: int, d: int, n_log: int,
                           page: int) -> int:
    """f32 elements of the decode kernel's per-call workspace: for every
    (row, KV head) and every split a table ``n_log`` pages wide can have,
    the split's running acc [G, D] and its (m, l) [G] statistics
    (csrc/paged_decode.cu, DecodeArgs.work). A pure function of the
    shapes; the wrapper allocates exactly this."""
    return b * hkv * decode_splits(n_log, page) * g * (d + 2)


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
    if q.numel() == 0 or dev.type == "meta":
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
    if q.numel() == 0 or dev.type == "meta":
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
    real slot. Returns ``o [B, Hkv, G, D]`` in q's dtype.

    On the card each call allocates an f32 workspace of
    `decode_workspace_elems` = ``B · Hkv · decode_splits(n_log, page) · G ·
    (D + 2)`` elements, a pure function of the shapes, which the split launch fills and the combine
    launch reads: a CUDA graph that captures this call captures that
    allocation too."""
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
    if not paged_decode_ok(g, page, d, q.dtype):
        smem = _decode_smem_bytes(g, d, q.element_size())
        raise ValueError(f"G={g}, page={page}, D={d}: the decode kernel "
                         f"takes page >= {PAGE_MIN}, D a multiple of "
                         f"{_DECODE_D_ALIGN} up to {_DECODE_D_MAX} and "
                         f"shared memory within {SMEM_LIMIT} B ({smem})")
    out = torch.empty_like(q)
    work = torch.empty(decode_workspace_elems(b, hkv, g, d, n_log, page),
                       dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return out
    rc = _bind("paged_decode", 8, 6)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), start.data_ptr(),
        out.data_ptr(), work.data_ptr(), b, hkv, g, d, page, n_log,
        float(sm_scale), int(window), float(softcap),
        build.dtype_code(q.dtype), build.stream_handle(dev))
    _check_rc("paged_decode", rc)
    LAUNCHES["paged_decode"] += 1
    return out
