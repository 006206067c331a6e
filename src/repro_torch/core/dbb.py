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
the reference's uint32 for B ≤ 31). ``bits=8`` stores one value per
element, in the weight's own dtype (int8 for a quantized leaf, whose
per-channel ``scale [N]`` rides along). ``bits=4`` (``pack_dbb(...,
bits=4, group=G)``) quantizes symmetrically to [-7, 7] per group of G
dense K rows, keeps the top-k on that INT4 grid and nibble-packs the
values plane to ``[K//B * k // 2, N]`` int8 — packed row i holds
compressed row 2i in the low nibble and 2i+1 in the high one — with the
group scales in ``scale [K//G, N]`` f32. G is a multiple of B, so every
dense position of block kb lies in scale group kb·B // G.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["DbbWeight", "dbb_mask", "dbb_project", "pack_dbb", "unpack_dbb",
           "decompress_bitmask", "dequantize_groups", "pack_nibbles",
           "unpack_nibbles", "INT4_MAX", "dense_footprint_bytes",
           "dbb_footprint_bytes", "validate_dbb"]

# symmetric INT4 grid [-7, 7] (the -8 code is unused, like INT8's -128)
INT4_MAX = 7


@dataclasses.dataclass(frozen=True)
class DbbWeight:
    """Packed DBB weight; leading dims (a layer stack) may precede the
    ``[rows, N]`` planes."""
    values: torch.Tensor             # [..., K//B * k, N] (bits=4: [.., /2, N])
    indices: Optional[torch.Tensor]  # [..., K//B * k, N] int32, or None
    bitmask: torch.Tensor            # [..., K//B, N] int32
    scale: Optional[torch.Tensor]    # [..., N] per-channel (bits=8),
                                     # [..., K//G, N] groupwise (bits=4)
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
    B-block along K, ties broken toward the lower index (the set
    `_top_slots` selects). Found without a sort, which would dominate a
    train step's projection: each entry gets a distinct int64 key — |w|'s
    f32 bits (monotone for non-negative floats) above the inverted index —
    and min(nnz, B - nnz) passes peel the largest (or smallest) key off
    every block to find the cut."""
    k_dim, n = w.shape
    _check_dims(k_dim, block, nnz)
    if nnz == block:
        return torch.ones_like(w, dtype=torch.bool)
    mag = w.abs().float().reshape(k_dim // block, block, n)   # [Kb, B, N]
    rev = torch.arange(block - 1, -1, -1, device=w.device)
    key = mag.view(torch.int32).long() * block + rev[None, :, None]
    left = key
    if nnz <= block - nnz:                    # peel the nnz largest
        for _ in range(nnz):
            cut = left.amax(dim=1, keepdim=True)
            left = torch.where(left == cut, -1, left)
        keep = key >= cut
    else:                                     # peel the B - nnz smallest
        for _ in range(block - nnz):
            cut = left.amin(dim=1, keepdim=True)
            left = torch.where(left == cut, torch.iinfo(torch.int64).max,
                               left)
        keep = key > cut
    return keep.reshape(k_dim, n)


def dbb_project(w: torch.Tensor, block: int, nnz: int) -> torch.Tensor:
    """Project a dense matrix onto the DBB constraint set (zero the rest)."""
    return torch.where(dbb_mask(w, block, nnz), w, torch.zeros_like(w))


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Nibble-pack int8 rows in [-8, 7]: ``[R, N] → [R//2, N]`` int8, packed
    row i = row 2i in the low nibble, row 2i+1 in the high nibble. R must
    be even. The bit arithmetic runs in int16 (no int8 shift wraparound)."""
    r, _ = q.shape
    if r % 2 != 0:
        raise ValueError(f"nibble packing needs an even row count, got {r}")
    u = q.to(torch.int16) & 0xF
    return (u[0::2] | (u[1::2] << 4)).to(torch.uint8).view(torch.int8)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_nibbles`: ``[R//2, N] int8 → [R, N] int8``, each
    nibble sign-extended through int32 (``(p << 28) >> 28`` low,
    ``p >> 4`` high)."""
    r2, n = packed.shape
    p = packed.to(torch.int32)
    lo, hi = (p << 28) >> 28, p >> 4
    return torch.stack([lo, hi], dim=1).reshape(r2 * 2, n).to(torch.int8)


def _check_w4_dims(k_dim: int, block: int, nnz: int, group: int) -> None:
    if group <= 0 or group % block != 0:
        raise ValueError(f"group={group} must be a positive multiple of "
                         f"block={block} (scale groups cover whole blocks)")
    if k_dim % group != 0:
        raise ValueError(f"K={k_dim} not divisible by group={group}")
    if (k_dim // block * nnz) % 2 != 0:
        raise ValueError(
            f"K//B·k = {k_dim // block * nnz} compressed rows must be even "
            f"to nibble-pack (K={k_dim}, block={block}, nnz={nnz})")


def pack_dbb(w: torch.Tensor, block: int = 8, nnz: int = 4,
             scale: Optional[torch.Tensor] = None, bits: int = 8,
             group: int = 128) -> DbbWeight:
    """Compress ``W[K, N]`` to the DBB format (selecting the top-``nnz``
    magnitudes of every block, so unprojected input is projected too).
    ``bits=4`` quantizes per ``group`` dense K rows and nibble-packs (see
    the module doc); it derives its scales itself, so a caller ``scale``
    is refused there."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits} not supported (4 or 8)")
    if bits == 4:
        if scale is not None:
            raise ValueError("bits=4 derives groupwise scales itself; "
                             "per-channel scale is the bits=8 format")
        return _pack_dbb_w4(w, block, nnz, group)
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


def _pack_dbb_w4(w: torch.Tensor, block: int, nnz: int,
                 group: int) -> DbbWeight:
    """bits=4 pack: groupwise symmetric quantize to [-7, 7] in f32
    (``torch.round`` rounds half to even, as ``jnp.round``), DBB-select on
    the quantized grid with the bits=8 pack (so the bitmask matches the
    stored INT4 values exactly), then nibble-pack the values plane."""
    k_dim, n = w.shape
    _check_dims(k_dim, block, nnz)
    _check_w4_dims(k_dim, block, nnz, group)
    g = w.to(torch.float32).reshape(k_dim // group, group, n)
    scale = g.abs().amax(dim=1) / INT4_MAX
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(g / scale[:, None, :]), -INT4_MAX, INT4_MAX)
    p8 = pack_dbb(q.reshape(k_dim, n).to(torch.int8), block, nnz)
    return dataclasses.replace(p8, values=pack_nibbles(p8.values),
                               scale=scale.contiguous(), bits=4, group=group)


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


def dequantize_groups(dense: torch.Tensor, gscale: torch.Tensor,
                      group: int) -> torch.Tensor:
    """f32 ``[K, N]`` of an integer-valued dense ``[K, N]`` times its
    groupwise ``gscale [K//G, N]`` (one f32 product per weight)."""
    k_dim, n = dense.shape
    grouped = dense.to(torch.float32).reshape(k_dim // group, group, n)
    return (grouped * gscale[:, None, :]).reshape(k_dim, n)


def unpack_dbb(p: DbbWeight) -> torch.Tensor:
    """Dense ``[K, N]`` of a 2-D `DbbWeight`, scale applied (``bits=4``:
    nibbles sign-extended, then dequantized groupwise to f32). Leaves
    whose ``indices`` were stripped (serving) decompress by bitmask
    rank."""
    kb, n, k = p.num_blocks, p.n_dim, p.nnz
    values = unpack_nibbles(p.values) if p.bits == 4 else p.values
    if p.indices is None:
        out = decompress_bitmask(values, p.bitmask, block=p.block)
    else:
        vals = values.reshape(kb, k, n)
        idx = p.indices.reshape(kb, k, n).long()
        dense = torch.zeros((kb, p.block, n), dtype=vals.dtype,
                            device=vals.device)
        # live slots hold distinct positions; dead slots carry zero values
        dense.scatter_add_(1, idx, vals)
        out = dense.reshape(p.k_dim, n)
    if p.bits == 4:
        return dequantize_groups(out, p.scale, p.group)
    if p.scale is not None:
        out = out * p.scale[None, :]
    return out


def dense_footprint_bytes(k_dim: int, n: int, itemsize: int = 1) -> int:
    return k_dim * n * itemsize


def dbb_footprint_bytes(k_dim: int, n: int, block: int, nnz: int,
                        itemsize: int = 1, bits: int = 8,
                        group: int = 0) -> int:
    """Compressed bytes: values + one mask byte per block (paper §IV-A).
    ``bits=4`` halves the values plane and adds the f32 ``[K//G, N]``
    scale plane."""
    kb = k_dim // block
    mask_bytes = (block + 7) // 8
    if bits == 4:
        val_bytes = (kb * nnz + 1) // 2 * n       # two slots per byte
        scale_bytes = (k_dim // group) * n * 4 if group > 0 else 0
        return val_bytes + kb * n * mask_bytes + scale_bytes
    return kb * n * (nnz * itemsize + mask_bytes)


def validate_dbb(p: DbbWeight) -> Tuple[bool, str]:
    """Invariant check of a 2-D leaf that still has its indices: indices
    in range, live indices increasing within a block (spot-checked on
    the first 64 blocks and columns), at most ``nnz`` live values."""
    if p.indices is None:
        return False, "indices plane stripped (serving format); " \
                      "validate against the host-side copy"
    values = unpack_nibbles(p.values) if p.bits == 4 else p.values
    vals = values.reshape(p.num_blocks, p.nnz, p.n_dim).cpu()
    idx = p.indices.reshape(p.num_blocks, p.nnz, p.n_dim).cpu()
    if idx.min() < 0 or idx.max() >= p.block:
        return False, f"index out of range [0,{p.block})"
    nz = vals.abs() > 0
    for b in range(min(p.num_blocks, 64)):
        for col in range(min(p.n_dim, 64)):
            live = idx[b, nz[b, :, col], col]
            if live.numel() and bool((live.diff() < 0).any()):
                return False, f"indices not sorted in block {b} col {col}"
    if int(nz.sum(dim=1).max()) > p.nnz:
        return False, "NNZ bound violated"
    return True, "ok"
