"""Plain PyTorch version of the paged decode kernel: gather the row's
pages back into a contiguous cache and run the quadratic masked softmax.

Mask convention (absolute cache slots): key ``kk`` of row ``b`` is valid
iff ``start[b] <= kk <= lengths[b]`` (and ``kk > lengths[b] - window``).
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "gather_pages", "paged_decode_ref"]

NEG_INF = -1e30


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
    """q [B, Hkv, G, D] → o [B, Hkv, G, D] in q's dtype. Scores in f32,
    probabilities cast to V's dtype for P·V with f32 accumulation."""
    k = gather_pages(k_pages, block_table)                   # [B, S, H, D]
    v = gather_pages(v_pages, block_table)
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * sm_scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kk = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = (kk <= lengths[:, None]) & (kk >= start[:, None])
    if window > 0:
        valid &= kk > (lengths[:, None] - window)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)
