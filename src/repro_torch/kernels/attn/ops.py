"""Wrapper of the paged decode attention kernel (csrc/paged_decode.cu).

A contiguous ``[B, S, Hkv, D]`` cache is served by the same wrapper as the
pool ``[B · S/page, page, Hkv, D]`` (a view, no copy) under an identity
block table — one kernel, one page-visit order for both layouts.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attn.ref import paged_decode_ref
from repro_torch.kernels.common import FLOAT_DTYPES, LAUNCHES, check_operand

__all__ = ["paged_decode_attention", "identity_block_table", "DEFAULT_PAGE",
           "paged_decode_ok", "PAGE_MIN", "SMEM_LIMIT"]

# default KV page (slots) when the config leaves kv_page_size unset
DEFAULT_PAGE = 64
# smallest page the decode route takes: one warp scores a key at a time,
# so pages under 8 slots leave the block's warps mostly idle per page
PAGE_MIN = 8
# a block's shared memory on the H100 (227 KB usable)
SMEM_LIMIT = 232448


def _smem_bytes(g: int, d: int, page: int) -> int:
    """Shared memory of one decode block: q and acc [G, D], the page's
    scores [G, page] and three [G] running statistics, all f32."""
    return 4 * (2 * g * d + g * page + 3 * g)


def paged_decode_ok(group: int, page: int, d: int) -> bool:
    """Whether the decode kernel's shared memory fits one block."""
    return _smem_bytes(group, d, page) <= SMEM_LIMIT


def identity_block_table(b: int, n_log: int,
                         device: torch.device) -> torch.Tensor:
    """Row ``b``'s logical page ``j`` → physical page ``b * n_log + j``."""
    return (torch.arange(b, dtype=torch.int32, device=device)[:, None] * n_log
            + torch.arange(n_log, dtype=torch.int32, device=device)[None, :])


def _launcher():
    fn = build.load("paged_decode").paged_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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
                         f"{_smem_bytes(g, d, page)} B over {SMEM_LIMIT}")
    out = torch.empty_like(q)
    rc = _launcher()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), start.data_ptr(),
        out.data_ptr(), b, hkv, g, d, page, n_log, float(sm_scale),
        int(window), float(softcap), build.dtype_code(q.dtype),
        build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError {rc}")
    LAUNCHES["paged_decode"] += 1
    return out
