"""Paged KV cache: fixed-size pages, free-list allocation, per-row block
tables.

The contiguous decode cache reserves ``smax`` slots for every batch slot;
the paged cache splits KV storage into a pool of fixed-size pages
(``[L, P, page, Hkv, D]``) shared by all slots. A request is admitted with
``ceil((prompt + budget) / page)`` pages and a block-table row mapping its
logical pages to wherever the allocator placed them.

Physical **page 0 is a reserved dummy**: unallocated block-table entries
point at it, so the fixed-width admission scatter and the clamped
overshoot writes of retired-but-still-stepping slots land there instead of
in a live row. Every read of it is masked by the owning row's
``length``/``start``, and live rows never map to it.

`PageAllocator` is host-side Python (admission happens between decode
chunks on the host); only the pools, tables and lengths live on the device.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import dtype_of

__all__ = ["PageAllocator", "init_paged_cache", "pages_needed", "DUMMY_PAGE"]

DUMMY_PAGE = 0


def pages_needed(prompt_len: int, budget: int, page: int) -> int:
    """Pages a request touches: its prompt slots plus one slot per
    generated token (the first comes from prefill; decode writes slots
    ``prompt .. prompt + budget - 1``)."""
    return -(-(prompt_len + max(budget, 1)) // page)


class PageAllocator:
    """Free-list allocator over the physical page pool. Page 0 (the dummy)
    is never handed out; pages are recycled LIFO."""

    def __init__(self, total_pages: int):
        if total_pages < 2:
            raise ValueError("the pool needs the dummy page plus one")
        self.total_pages = total_pages
        self._free: List[int] = list(range(total_pages - 1, DUMMY_PAGE, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.total_pages - 1) - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` physical page ids, or None if the pool cannot cover them
        (the caller defers the admission until retirements free pages)."""
        if n > len(self._free):
            return None
        got = self._free[-n:]
        del self._free[-n:]
        return got

    def free(self, pages: List[int]) -> None:
        if DUMMY_PAGE in pages:
            raise ValueError("the dummy page is never allocated")
        self._free.extend(pages)


def init_paged_cache(cfg: ModelConfig, n_slots: int, pool_pages: int,
                     page: int, n_log: int, device="cuda") -> Dict:
    """Paged decode cache on ``device``.

    k_pages/v_pages: [L, P, page, Hkv, D] pools in the activation dtype
                     (page 0 = dummy).
    block_table:     [n_slots, n_log] int32, logical → physical page
                     (unadmitted and retired rows point wholly at the dummy).
    length/start:    per-slot absolute context length and first real slot,
                     as in the contiguous cache.
    """
    dev = resolve_device(device)
    shape = (cfg.num_layers, pool_pages, page, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    i32 = dict(dtype=torch.int32, device=dev)
    return {
        "k_pages": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
        "v_pages": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
        "block_table": torch.zeros((n_slots, n_log), **i32),
        "length": torch.zeros((n_slots,), **i32),
        "start": torch.zeros((n_slots,), **i32),
    }
