"""Packed parameter trees: `pack_tree` turns dense (projected) weights into
serving `DbbWeight` leaves (bits=8 float or int8 values, or the w4 nibble
plane), `decompress` expands one back to dense (the plain path's transient
per-layer weight) and `maybe_decompress_tree` every packed leaf of a tree,
`dbb_linear_apply` is ``act(x @ w + b)`` on a dense or packed weight,
`tree_footprint_bytes` counts device residency."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.config import DbbConfig
from repro_torch.core.dbb import DbbWeight, pack_dbb, unpack_dbb
from repro_torch.core.quant import quantize_weight
from repro_torch.core.sparsity import map_with_path, packable

__all__ = ["decompress", "maybe_decompress_tree", "dbb_linear_apply",
           "pack_tree", "tree_footprint_bytes", "iter_leaves"]


def decompress(p: DbbWeight, dtype: Optional[torch.dtype] = None
               ) -> torch.Tensor:
    """Dense ``[..., K, N]``: `unpack_dbb` of each matrix of the stack —
    scale applied in f32 (a w4 leaf dequantized groupwise, an int8-valued
    leaf times its per-channel scale) — then cast to ``dtype``; the plain
    counterpart of the reference's `decompress_xla`."""
    lead = p.values.shape[:-2]
    flat = p.map(lambda a: a.reshape(-1, *a.shape[len(lead):]))
    w = torch.stack([unpack_dbb(flat.map(lambda a: a[i]))
                     for i in range(flat.values.shape[0])])
    w = w.reshape(*lead, p.k_dim, p.n_dim)
    return w.to(dtype) if dtype is not None else w


def maybe_decompress_tree(params: Any,
                          dtype: Optional[torch.dtype] = None) -> Any:
    """The tree with every `DbbWeight` leaf expanded to dense (`decompress`
    to ``dtype``); other leaves as they are."""
    if isinstance(params, dict):
        return {k: maybe_decompress_tree(v, dtype) for k, v in params.items()}
    if isinstance(params, DbbWeight):
        return decompress(params, dtype=dtype)
    return params


def dbb_linear_apply(x: torch.Tensor, w, bias=None, *, act: str = "none",
                     impl: str = "xla",
                     out_dtype: Optional[torch.dtype] = None,
                     cfg=None) -> torch.Tensor:
    """``act(x @ w + bias)`` for a dense ``[K, N]`` weight or a
    `DbbWeight`, through `dispatch.matmul`: ``impl="pallas"`` takes the
    kernel route family (the DBB kernels for packed weights, bias, act and
    the per-channel scale in their epilogue), ``"xla"`` the plain route.
    ``cfg`` supplies ``kernel_routes`` pins."""
    from repro_torch.kernels import dispatch
    return dispatch.matmul(x, w, bias, act=act, out_dtype=out_dtype,
                           cfg=cfg, pallas=(impl == "pallas"))


def _w4_eligible(k_dim: int, cfg: DbbConfig) -> bool:
    """Whether a leaf of contraction dim ``k_dim`` takes the w4 plane under
    ``cfg`` (the group divides K into whole blocks and the compressed row
    count is even); other leaves stay bits=8 packed."""
    g = cfg.quant_group
    return (cfg.weight_bits == 4 and g > 0 and g % cfg.block == 0
            and k_dim % g == 0 and (k_dim // cfg.block * cfg.nnz) % 2 == 0)


def pack_tree(params: Any, cfg: DbbConfig, quantize: bool = False) -> Any:
    """Pack every DBB-eligible dense leaf into a serving `DbbWeight`
    without the diagnostic indices. Stacked ``[L, K, N]`` leaves pack one
    matrix at a time.

    ``cfg.weight_bits == 4``: every leaf `_w4_eligible` allows is quantized
    groupwise from f32 and nibble-packed (``bits=4``, ``group`` G), the
    rest stay bits=8. ``quantize=True`` stores the bits=8 leaves' values as
    int8 with per-channel ``scale [..., N]`` (the paper's deployment
    format); otherwise values keep the leaf's own dtype."""
    if not cfg.enabled:
        return params

    def visit(path, leaf):
        if not packable(path, leaf, cfg):
            return leaf
        kd, n = leaf.shape[-2:]
        w4 = _w4_eligible(kd, cfg)

        def pack_one(w):
            if w4:
                return pack_dbb(w.to(torch.float32), cfg.block, cfg.nnz,
                                bits=4, group=cfg.quant_group)
            if quantize:
                qw = quantize_weight(w.to(torch.float32))
                return pack_dbb(qw.q, cfg.block, cfg.nnz, scale=qw.scale)
            return pack_dbb(w, cfg.block, cfg.nnz)

        packed = [pack_one(w) for w in leaf.reshape(-1, kd, n)]
        lead = leaf.shape[:-2]

        def stack(planes):
            return torch.stack(planes).reshape(*lead, *planes[0].shape)
        scale = packed[0].scale
        return DbbWeight(
            values=stack([p.values for p in packed]), indices=None,
            bitmask=stack([p.bitmask for p in packed]),
            scale=None if scale is None else stack([p.scale for p in packed]),
            block=cfg.block, nnz=cfg.nnz, k_dim=kd, bits=4 if w4 else 8,
            group=cfg.quant_group if w4 else 0)

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
    its values, its scale plane and one mask byte per block — the paper's
    storage format — not the int32 bitmask the kernels read. The block
    count is ``bitmask.numel()``, which holds for nibble-packed values
    too."""
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
