"""Plain PyTorch versions of the attention kernels: the quadratic masked
softmax over the whole score tensor (what the flash kernels never
materialise), and, for paged decode, the row's pages gathered back into a
contiguous cache first.

Mask convention (absolute key/query slots): key ``kj`` is valid for query
``qi`` of row ``b`` iff ``start[b] <= kj <= qi`` (and ``kj > qi - window``);
decode's query sits at ``qi = lengths[b]``. Packed batches replace the
``start`` bound with equal segment ids. Scores are f32, the softcap
applies before the mask, and probabilities are cast to V's dtype for P·V
with f32 accumulation.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["NEG_INF", "flash_prefill_ref", "packed_prefill_ref",
           "gather_pages", "paged_decode_ref"]

NEG_INF = -1e30


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap > 0 else s


def _softmax_pv(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
                pv: str) -> torch.Tensor:
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum(pv, p.to(v.dtype).float(), v.float())


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      start: Optional[torch.Tensor] = None,
                      q_offset: Optional[torch.Tensor] = None, *,
                      sm_scale: float, window: int = 0,
                      softcap: float = 0.0) -> torch.Tensor:
    """q [B, Hq, T, D], k/v [B, Hkv, S, D] → o [B, Hq, T, D] in q's dtype.
    ``start`` [B]: first real key slot; ``q_offset`` [B]: absolute slot of
    query row 0 (a chunked-prefill continuation)."""
    b, hq, t, _ = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    start = (torch.zeros(b, dtype=torch.int32, device=dev) if start is None
             else start.reshape(b))
    q_offset = (torch.zeros(b, dtype=torch.int32, device=dev)
                if q_offset is None else q_offset.reshape(b))
    kg = k.repeat_interleave(g, dim=1)                   # [B, Hq, S, D]
    vg = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), kg.float()) * sm_scale
    s = _softcap(s, softcap)
    qi = (torch.arange(t, device=dev)[None, :] + q_offset[:, None])
    qi = qi[:, None, :, None]
    kj = torch.arange(s_len, device=dev)[None, None, None, :]
    mask = (kj <= qi) & (kj >= start[:, None, None, None])
    if window > 0:
        mask &= kj > qi - window
    return _softmax_pv(s, mask, vg, "bhts,bhsd->bhtd").to(q.dtype)


def packed_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       seg_ids: torch.Tensor, *, sm_scale: float,
                       window: int = 0, softcap: float = 0.0
                       ) -> torch.Tensor:
    """q [Hq, T, D], k/v [Hkv, T, D], seg_ids [T] (non-decreasing) → o
    [Hq, T, D]: block-diagonal causal — a query attends a key iff they
    share a segment id and the key is not later."""
    hq, t, _ = q.shape
    g = hq // k.shape[0]
    seg = seg_ids.reshape(t)
    kg = k.repeat_interleave(g, dim=0)                   # [Hq, T, D]
    vg = v.repeat_interleave(g, dim=0)
    s = torch.einsum("htd,hsd->hts", q.float(), kg.float()) * sm_scale
    s = _softcap(s, softcap)
    qi = torch.arange(t, device=q.device)[:, None]
    kj = torch.arange(t, device=q.device)[None, :]
    mask = (kj <= qi) & (seg[:, None] == seg[None, :])
    if window > 0:
        mask &= kj > qi - window
    return _softmax_pv(s, mask[None], vg, "hts,hsd->htd").to(q.dtype)


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor
                 ) -> torch.Tensor:
    """[P, page, H, D] pool + [B, n_log] table → contiguous [B, S, H, D]."""
    b, n_log = block_table.shape
    _, page, h, d = pages.shape
    return pages[block_table.long()].reshape(b, n_log * page, h, d)


def paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, block_table: torch.Tensor,
                     lengths: torch.Tensor, start: torch.Tensor, *,
                     sm_scale: float, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """q [B, Hkv, G, D] → o [B, Hkv, G, D] in q's dtype."""
    k = gather_pages(k_pages, block_table)                   # [B, S, H, D]
    v = gather_pages(v_pages, block_table)
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * sm_scale
    s = _softcap(s, softcap)
    kk = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = (kk <= lengths[:, None]) & (kk >= start[:, None])
    if window > 0:
        valid &= kk > (lengths[:, None] - window)
    return _softmax_pv(s, valid[:, None, None, :], v,
                       "bhgs,bshd->bhgd").to(q.dtype)
