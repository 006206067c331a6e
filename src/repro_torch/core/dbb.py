"""Density-Bound Block (DBB) structured-sparse weight format (paper §IV-A).

A weight ``W[K, N]`` (contraction dim first, as in ``x @ W``) is split into
``B×1`` blocks along K, each holding at most ``k`` non-zeros:

  values  [K//B * k, N]  surviving values, slot-major (row kb*k + s holds
                         slot s of block kb), live slots first, zero-padded
  bitmask [K//B, N]      int32, bit ``pos`` set ⇔ dense row kb*B + pos kept;
                         rank(pos) = popcount of the lower bits is the slot
  indices [K//B * k, N]  block-local positions of the values (int32) —
                         diagnostics only; serving leaves drop them

The layout and tie rules are the JAX package's, so packed planes are
byte-equal across the two (the bitmask is int32 here, the same bytes as
the reference's uint32 for B ≤ 31). Only ``bits=8`` (one value per element,
in the weight's own dtype) is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["DbbWeight", "dbb_mask", "dbb_project", "pack_dbb", "unpack_dbb",
           "decompress_bitmask"]


@dataclasses.dataclass(frozen=True)
class DbbWeight:
    """Packed DBB weight; leading dims (a layer stack) may precede the
    ``[rows, N]`` planes."""
    values: torch.Tensor             # [..., K//B * k, N]
    indices: Optional[torch.Tensor]  # [..., K//B * k, N] int32, or None
    bitmask: torch.Tensor            # [..., K//B, N] int32
    scale: Optional[torch.Tensor]    # [..., N] per-channel, or None
    block: int = 8
    nnz: int = 4
    k_dim: int = 0
    bits: int = 8
    group: int = 0

    @property
    def n_dim(self) -> int:
        return self.values.shape[-1]

    @property
    def num_blocks(self) -> int:
        return self.k_dim // self.block

    def map(self, fn) -> "DbbWeight":
        """Apply ``fn`` to every tensor plane (device moves, layer slices)."""
        return dataclasses.replace(
            self, values=fn(self.values), bitmask=fn(self.bitmask),
            indices=None if self.indices is None else fn(self.indices),
            scale=None if self.scale is None else fn(self.scale))


def _check_dims(k_dim: int, block: int, nnz: int) -> None:
    if k_dim % block != 0:
        raise ValueError(f"K={k_dim} not divisible by DBB block={block}")
    if not (1 <= nnz <= block):
        raise ValueError(f"nnz={nnz} must be in [1, block={block}]")


def _top_slots(mag: torch.Tensor, nnz: int) -> torch.Tensor:
    """Indices of the ``nnz`` largest entries along the last axis, ties to
    the lowest index. A stable sort on −|w| gives that order; `topk` does
    not fix the order of equal values."""
    order = torch.sort(-mag, dim=-1, stable=True).indices
    return order[..., :nnz]


def dbb_mask(w: torch.Tensor, block: int, nnz: int) -> torch.Tensor:
    """Boolean keep-mask of ``w [K, N]``: the ``nnz`` largest |w| of every
    B-block along K, ties broken toward the lower index."""
    k_dim, n = w.shape
    _check_dims(k_dim, block, nnz)
    if nnz == block:
        return torch.ones_like(w, dtype=torch.bool)
    blocks = w.abs().reshape(k_dim // block, block, n).transpose(1, 2)
    idx = _top_slots(blocks, nnz)                            # [Kb, N, k]
    keep = torch.zeros(blocks.shape, dtype=torch.bool, device=w.device)
    keep.scatter_(-1, idx, True)
    return keep.transpose(1, 2).reshape(k_dim, n)


def dbb_project(w: torch.Tensor, block: int, nnz: int) -> torch.Tensor:
    """Project a dense matrix onto the DBB constraint set (zero the rest)."""
    return torch.where(dbb_mask(w, block, nnz), w, torch.zeros_like(w))


def pack_dbb(w: torch.Tensor, block: int = 8, nnz: int = 4,
             scale: Optional[torch.Tensor] = None, bits: int = 8
             ) -> DbbWeight:
    """Compress ``W[K, N]`` to the DBB format (selecting the top-``nnz``
    magnitudes of every block, so unprojected input is projected too)."""
    if bits != 8:
        raise NotImplementedError(
            f"bits={bits}: only the bits=8 format is ported")
    k_dim, n = w.shape
    _check_dims(k_dim, block, nnz)
    kb = k_dim // block
    blocks = w.reshape(kb, block, n).transpose(1, 2)         # [Kb, N, B]
    mag = blocks.abs()
    idx = _top_slots(mag, nnz).sort(dim=-1).values           # index-sorted
    vals = torch.gather(blocks, -1, idx)
    vals = torch.where(torch.gather(mag, -1, idx) > 0, vals,
                       torch.zeros_like(vals))
    live = vals.abs() > 0
    bitmask = torch.where(live, torch.ones_like(idx) << idx,
                          torch.zeros_like(idx)).sum(-1).to(torch.int32)
    # live-first slot order = bitmask-rank order, what the kernels'
    # popcount decompression assumes (dead zero slots trail)
    order = torch.argsort(torch.where(live, idx, idx + block), dim=-1)
    idx = torch.gather(idx, -1, order)
    vals = torch.gather(vals, -1, order)
    values = vals.permute(0, 2, 1).reshape(kb * nnz, n).contiguous()
    indices = idx.to(torch.int32).permute(0, 2, 1).reshape(kb * nnz, n)
    return DbbWeight(values=values, indices=indices.contiguous(),
                     bitmask=bitmask.contiguous(), scale=scale,
                     block=block, nnz=nnz, k_dim=k_dim)


def decompress_bitmask(values: torch.Tensor, bitmask: torch.Tensor, *,
                       block: int) -> torch.Tensor:
    """Bitmask-rank decompression ``[Kb·k, N] + [Kb, N] → [K, N]``: dense
    position ``pos`` of block kb is kept iff its bit is set, and its value
    sits in slot rank(pos) = popcount of the lower bits (clamped to k-1,
    as the kernels clamp)."""
    kbn, n = values.shape
    kb = bitmask.shape[0]
    k = kbn // kb
    vals = values.reshape(kb, k, n)
    pos = torch.arange(block, device=bitmask.device, dtype=torch.int32)
    bits = (bitmask[:, None, :] >> pos[None, :, None]) & 1    # [Kb, B, N]
    rank = (torch.cumsum(bits, dim=1) - bits).clamp(0, k - 1)
    gathered = torch.gather(vals, 1, rank.long())
    dense = torch.where(bits.bool(), gathered, torch.zeros_like(gathered))
    return dense.reshape(kb * block, n)


def unpack_dbb(p: DbbWeight) -> torch.Tensor:
    """Dense ``[K, N]`` of a 2-D `DbbWeight`, scale applied. Leaves whose
    ``indices`` were stripped (serving) decompress by bitmask rank."""
    if p.bits != 8:
        raise NotImplementedError(
            f"bits={p.bits}: only the bits=8 format is ported")
    kb, n, k = p.num_blocks, p.n_dim, p.nnz
    if p.indices is None:
        out = decompress_bitmask(p.values, p.bitmask, block=p.block)
    else:
        vals = p.values.reshape(kb, k, n)
        idx = p.indices.reshape(kb, k, n).long()
        dense = torch.zeros((kb, p.block, n), dtype=vals.dtype,
                            device=vals.device)
        # live slots hold distinct positions; dead slots carry zero values
        dense.scatter_add_(1, idx, vals)
        out = dense.reshape(p.k_dim, n)
    if p.scale is not None:
        out = out * p.scale[None, :]
    return out
