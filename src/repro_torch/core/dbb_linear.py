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
from repro_torch.core.dbb import DbbWeight, pack_dbb
from repro_torch.core.quant import quantize_weight
from repro_torch.core.sparsity import map_with_path, packable

__all__ = ["decompress", "maybe_decompress_tree", "dbb_linear_apply",
           "pack_tree", "tree_footprint_bytes", "iter_leaves",
           "DECOMPRESS_STATS"]

# Every `decompress` call (every place a dense copy of a packed weight is
# built) adds one here, as the reference counts its ``decompress_xla``
# calls. A kernel-route decode step must leave it flat: the structural
# proof that no packed layer weight expands to dense
# (repro_torch.analysis.materialize, check ``decode-step-no-dense``).
DECOMPRESS_STATS = {"calls": 0}


def decompress(p: DbbWeight, dtype: Optional[torch.dtype] = None
               ) -> torch.Tensor:
    """Dense ``[..., K, N]`` of every matrix of the stack, scale applied in
    f32 (a w4 leaf dequantized groupwise, an int8-valued leaf times its
    per-channel scale), then cast to ``dtype``; the plain counterpart of
    the reference's `decompress_xla`. Bit-equal to `unpack_dbb` of each
    matrix of a valid plane (at most nnz bits a block): a bitmask plane's
    slots are scaled (k values a block, not its B rows) and scattered onto
    their blocks' set bits in one pass over a group of matrices."""
    DECOMPRESS_STATS["calls"] += 1
    lead = p.values.shape[:-2]
    flat = p.map(lambda a: a.reshape(-1, *a.shape[len(lead):]))
    if dtype is None:
        dtype = (torch.float32 if p.bits == 4 or p.scale is not None
                 else p.values.dtype)
    m, n = flat.values.shape[0], p.n_dim
    out = torch.empty((m, p.k_dim, n), dtype=dtype, device=p.values.device)
    step = max(1, _EXPAND_CHUNK // max(p.k_dim * n, 1))
    for i in range(0, m, step):
        _expand_into(out[i:i + step], flat.map(lambda a: a[i:i + step]))
    return out.reshape(*lead, p.k_dim, n)


# weights a `decompress` scatter expands at once (bounds its transients)
_EXPAND_CHUNK = 1 << 28


def _slot_rows(block: int, nnz: int, device) -> torch.Tensor:
    """``[nnz, 2^block]`` int64: the block row slot s of a block with
    bitmask m fills — m's s-th set bit (its rank is s) — or, for a dead
    slot (m has at most s bits set), m's lowest clear bit, which stays zero
    (a dead slot holds zero). Valid planes only: at most ``nnz`` bits
    set."""
    m = torch.arange(2 ** block, device=device)[:, None]
    bits = (m >> torch.arange(block, device=device)) & 1      # [2^B, B]
    rank = torch.cumsum(bits, 1) - bits
    slots = torch.arange(nnz, device=device)[None, :, None]
    live = (bits[:, None, :] == 1) & (rank[:, None, :] == slots)
    first_clear = (bits == 0).long().argmax(1)                 # first max
    return torch.where(live.any(2), live.long().argmax(2),
                       first_clear[:, None]).T


def _expand_into(out: torch.Tensor, p: DbbWeight) -> None:
    """Write the dense ``[c, K, N]`` of the c bitmask-plane matrices of
    ``p`` into ``out``: each block's slots scattered onto its rows."""
    c, n = p.values.shape[0], p.n_dim
    kb, k, blk = p.num_blocks, p.nnz, p.block
    vals = p.values
    if p.bits == 4:                      # as `unpack_nibbles`
        v = vals.to(torch.int32)
        vals = torch.stack([(v << 28) >> 28, v >> 4], dim=2)
    vals = vals.reshape(c, kb, k, n)
    if p.bits == 4:                      # as `dequantize_groups`
        group = torch.arange(kb, device=vals.device) * blk // p.group
        vals = vals.to(torch.float32) * p.scale[:, group, None, :]
    elif p.scale is not None:
        vals = vals.to(torch.float32) * p.scale[:, None, None, :]
    rows = _slot_rows(blk, k, vals.device)[:, p.bitmask.long()]
    dense = out.view(c, kb, blk, n)
    dense.zero_()
    dense.scatter_(2, rows.permute(1, 2, 0, 3), vals.to(out.dtype))


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
