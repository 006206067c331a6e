"""Packed parameter trees: `pack_tree` turns dense (projected) weights into
serving `DbbWeight` leaves, `decompress` expands one back to dense (the
plain path's transient per-layer weight), `tree_footprint_bytes` counts
device residency."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.config import DbbConfig
from repro_torch.core.dbb import DbbWeight, decompress_bitmask, pack_dbb
from repro_torch.core.sparsity import map_with_path, packable

__all__ = ["decompress", "pack_tree", "tree_footprint_bytes",
           "iter_leaves"]


def decompress(p: DbbWeight, dtype: Optional[torch.dtype] = None
               ) -> torch.Tensor:
    """Dense ``[..., K, N]`` from the values/bitmask planes by bitmask
    rank (leading stack dims are looped), scale applied, cast to
    ``dtype`` — the plain counterpart of the reference's `decompress_xla`."""
    if p.bits != 8:
        raise NotImplementedError(
            f"bits={p.bits}: only the bits=8 format is ported")
    lead = p.values.shape[:-2]
    vals = p.values.reshape(-1, *p.values.shape[-2:])
    mask = p.bitmask.reshape(-1, *p.bitmask.shape[-2:])
    w = torch.stack([decompress_bitmask(v, m, block=p.block)
                     for v, m in zip(vals, mask)])
    w = w.reshape(*lead, p.k_dim, p.n_dim)
    if p.scale is not None:
        w = w * p.scale[..., None, :]
    return w.to(dtype) if dtype is not None else w


def pack_tree(params: Any, cfg: DbbConfig) -> Any:
    """Pack every DBB-eligible dense leaf (bits=8, values in the leaf's own
    dtype) into a serving `DbbWeight` without the diagnostic indices.
    Stacked ``[L, K, N]`` leaves pack one matrix at a time."""
    if not cfg.enabled:
        return params
    if cfg.weight_bits != 8:
        raise NotImplementedError(
            f"weight_bits={cfg.weight_bits}: only bits=8 is ported")

    def visit(path, leaf):
        if not packable(path, leaf, cfg):
            return leaf
        kd, n = leaf.shape[-2:]
        flat = leaf.reshape(-1, kd, n)
        packed = [pack_dbb(w, cfg.block, cfg.nnz) for w in flat]
        lead = leaf.shape[:-2]
        values = torch.stack([p.values for p in packed]).reshape(
            *lead, *packed[0].values.shape)
        bitmask = torch.stack([p.bitmask for p in packed]).reshape(
            *lead, *packed[0].bitmask.shape)
        return DbbWeight(values=values, indices=None, bitmask=bitmask,
                         scale=None, block=cfg.block, nnz=cfg.nnz,
                         k_dim=kd)

    return map_with_path(visit, params)


def iter_leaves(tree: Any):
    """Depth-first leaves of a nested dict tree (`DbbWeight` is a leaf)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from iter_leaves(v)
    else:
        yield tree


def tree_footprint_bytes(params: Any) -> int:
    """Device residency of a (possibly packed) tree: a `DbbWeight` counts
    its values plus one mask byte per block — the paper's storage format —
    not the int32 bitmask the kernels read."""
    total = 0
    for leaf in iter_leaves(params):
        if isinstance(leaf, DbbWeight):
            total += leaf.values.numel() * leaf.values.element_size()
            total += leaf.bitmask.numel() * ((leaf.block + 7) // 8)
            if leaf.scale is not None:
                total += leaf.scale.numel() * leaf.scale.element_size()
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total
