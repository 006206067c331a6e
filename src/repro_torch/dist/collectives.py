"""The LM-head cross-entropy on one device, and the serving collectives of
tensor parallelism.

Logits are taken in f32, as in the JAX package. `cross_entropy` picks the
token-chunked form when the full ``[tokens, V]`` logits would be large.
The reference's vocab-parallel CE (the head column-sharded over a
"model" mesh axis) needs gradients through collectives and comes with
training on a mesh (ROADMAP.md, Queue 1, item 3).

The serving half runs on every rank of a live mesh (`dist.mesh_ctx`),
each holding plain local tensors; where the reference's shard_map bodies
call ``psum`` / ``all_gather``, these call ``torch.distributed`` over the
mesh axis's process group:

  * `all_reduce`: the boundary all-reduce after a row-parallel block,
    issued once. The reference splits it into chunks so that XLA can
    start the first chunk's transfer while the producing GEMM's epilogue
    stores the rest; in eager PyTorch the GEMM has finished before a
    collective is issued, so a chunk would only be one more collective;
  * `shard_embed_lookup`: the row-sharded embedding gather (in-range
    rows, zeros elsewhere, one all-reduce);
  * `shard_greedy` / `shard_sample`: the vocab-parallel heads — each rank
    reduces its column slice to one (score, global id) pair per row and a
    ``[tp, B]`` gather picks the winner, ties to the lowest global id as
    ``argmax`` takes them.

The reference's forms for a whole, unsharded head under a mesh
(``greedy_vocab_parallel``, ``greedy_scatter``, ``vocab_parallel_embed``)
serve its GSPMD path and come with training on a mesh (ROADMAP.md, Queue
1, item 3).

`all_gather` is an all-reduce of a zero-filled ``[tp, ...]`` buffer that
holds this rank's block at its index: x + 0 = x, so it is exact, and it
runs on both backends (gloo on CUDA tensors takes all-reduce and
broadcast only). Every collective leaves its input as it was.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["dense_ce", "dense_ce_chunked", "cross_entropy", "axis_size",
           "all_reduce", "all_gather", "shard_embed_lookup", "shard_greedy",
           "shard_sample"]

# live logits above this many elements (~1 GB f32) take the chunked form
CHUNK_LOGITS_ABOVE = 1 << 28


def _masked_mean(nll: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if mask is None:
        return nll.mean()
    m = mask.float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def _nll(h: torch.Tensor, w: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    logits = h.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - ll


def dense_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE with full ``[.., V]`` logits: h ``[B, S, d]`` · w
    ``[d, V]``."""
    return _masked_mean(_nll(h, w, labels), mask)


def _chunk_sums(hc: torch.Tensor, w: torch.Tensor, lc: torch.Tensor,
                mc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (_nll(hc, w, lc) * mc).sum(), mc.sum()


def dense_ce_chunked(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     rows: int = 8192) -> torch.Tensor:
    """CE with token-chunked logits: at most ``[rows, V]`` live. Each chunk
    runs under `torch.utils.checkpoint`, so its logits are recomputed in
    the backward pass instead of kept; the gradients equal `dense_ce`'s up
    to summation order."""
    b, s, d = h.shape
    t = b * s
    hf = h.reshape(t, d)
    lf = labels.reshape(t)
    mf = (torch.ones((t,), dtype=torch.float32, device=h.device)
          if mask is None else mask.reshape(t).float())
    # pad the token axis up to a rows multiple (mask 0: no contribution)
    # rather than searching for a divisor — a prime t would otherwise
    # collapse to one chunk and materialize the full [t, V] logits, the
    # blow-up this path exists to cap
    rows_eff = min(rows, t)
    t_pad = -(-t // rows_eff) * rows_eff
    if t_pad != t:
        hf = F.pad(hf, (0, 0, 0, t_pad - t))
        lf = F.pad(lf, (0, t_pad - t))
        mf = F.pad(mf, (0, t_pad - t))
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    m_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(t_pad // rows_eff):
        sl = slice(i * rows_eff, (i + 1) * rows_eff)
        n, m = checkpoint(_chunk_sums, hf[sl], w, lf[sl], mf[sl],
                          use_reentrant=False)
        nll_sum, m_sum = nll_sum + n, m_sum + m
    return nll_sum / torch.clamp(m_sum, min=1.0)


def cross_entropy(hidden: torch.Tensor, w_head: torch.Tensor,
                  labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LM-head CE dispatcher: token-chunked when the full logits tensor
    would pass ``CHUNK_LOGITS_ABOVE`` elements, plain dense otherwise."""
    if labels.numel() * w_head.shape[-1] > CHUNK_LOGITS_ABOVE:
        return dense_ce_chunked(hidden, w_head, labels, mask)
    return dense_ce(hidden, w_head, labels, mask)


# ---------------------------------------------------------------------------
# tensor-parallel serving collectives
# ---------------------------------------------------------------------------

def _live(axis: str):
    """The live mesh, which must have ``axis``."""
    from repro_torch.dist.mesh_ctx import current_mesh
    mesh = current_mesh()
    if mesh is None or axis not in mesh.axis_names:
        raise RuntimeError(
            f"collective over {axis!r} called outside a mesh: no live mesh "
            f"has an axis {axis!r}. Enter one with "
            "repro_torch.dist.mesh_ctx.use_mesh(make_mesh(...)), or use "
            "repro_torch.dist.mesh_ctx.axis_size for a size that is 1 "
            "without a mesh.")
    return mesh


def _axis(axis: str):
    """(mesh, this rank's index on ``axis``, its process group or None)."""
    mesh = _live(axis)
    return mesh, mesh.index[axis], mesh.groups.get(axis)


def axis_size(name: str = "model") -> int:
    """Size of the live mesh's axis ``name``; raises outside a mesh."""
    return int(_live(name).shape[name])


def all_reduce(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``, in x's dtype (a new
    tensor; every rank gets the same bits)."""
    import torch.distributed as dist
    _, _, group = _axis(axis)
    y = x.clone(memory_format=torch.contiguous_format)
    if group is not None:
        dist.all_reduce(y, group=group)
    return y


def all_gather(x: torch.Tensor, axis: str = "model",
               dim: Optional[int] = None) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``: stacked ``[tp, *x.shape]``, or,
    with ``dim``, concatenated along it (rank order = index order)."""
    mesh, idx, _ = _axis(axis)
    tp = mesh.shape[axis]
    buf = torch.zeros((tp, *x.shape), dtype=x.dtype, device=x.device)
    buf[idx] = x
    out = all_reduce(buf, axis)
    if dim is None:
        return out
    return torch.cat(out.unbind(0), dim=dim)


def shard_embed_lookup(table_local: torch.Tensor, tokens: torch.Tensor,
                       dtype: torch.dtype, axis: str = "model"
                       ) -> torch.Tensor:
    """The row-sharded embedding gather of one rank: its table holds one
    contiguous vocab slice; tokens in it gather, the others give zeros,
    and one f32 all-reduce assembles the rows (exactly: one term is not
    zero)."""
    _, idx, _ = _axis(axis)
    v_loc = table_local.shape[0]
    loc = tokens.long() - idx * v_loc
    in_range = (loc >= 0) & (loc < v_loc)
    emb = table_local[loc.clamp(0, v_loc - 1)].float()
    emb = torch.where(in_range[..., None], emb, torch.zeros((), device=emb.device))
    return all_reduce(emb, axis).to(dtype)


def _combine(score: torch.Tensor, gid: torch.Tensor, axis: str
             ) -> torch.Tensor:
    """The global winner of per-rank (best score [B], global id [B]) pairs:
    the first maximum over ranks in vocab order, so ties go to the lowest
    global id as ``argmax`` over the whole row takes them. One gather of
    both as f64 (exact for an f32 score and an id below 2^53)."""
    pairs = all_gather(torch.stack([score.double(), gid.double()]),
                       axis)                                   # [tp, 2, B]
    winner = torch.argmax(pairs[:, 0], dim=0)                  # first max
    return pairs[:, 1].gather(0, winner[None])[0].to(torch.int32)


def _greedy_combine(logits_loc: torch.Tensor, axis: str = "model"
                    ) -> torch.Tensor:
    """Global greedy argmax from per-rank ``[B, V/tp]`` logit slices."""
    _, idx, _ = _axis(axis)
    v_loc = logits_loc.shape[-1]
    loc_max, loc_arg = logits_loc.max(dim=-1)    # first max within a slice
    return _combine(loc_max, loc_arg + idx * v_loc, axis)


def shard_greedy(h: torch.Tensor, w_head_local: torch.Tensor, *,
                 impl: str = "xla", cfg=None, axis: str = "model"
                 ) -> torch.Tensor:
    """Greedy head of one rank: the head GEMV on its column slice ``[d,
    V/tp]`` (the skinny kernel applies at the local width), then the
    scalar combine."""
    from repro_torch.kernels import dispatch
    logits = dispatch.matmul(h.float().contiguous(), w_head_local.float(),
                             cfg=cfg, pallas=(impl == "pallas"), gemv=True)
    return _greedy_combine(logits, axis)


def shard_sample(h: torch.Tensor, w_head_local: torch.Tensor,
                 counts: torch.Tensor, temp, rep, pres, freq, seed, step, *,
                 top_k=None, top_p=None, use_tt: bool = False,
                 impl: str = "xla", cfg=None, axis: str = "model"
                 ) -> torch.Tensor:
    """Vocab-parallel sampling head of one rank, the twin of
    `shard_greedy`: the head GEMV and sampling epilogue on its column
    slice with the noise keyed to GLOBAL vocab ids (``base`` = the
    slice's first id), reduced to one (best score, global id) pair per
    row, and the same combine — each column's score equals that of a
    single-device run over the whole row, so the token does too.
    ``counts [B, V]`` arrives whole; each rank reads its window. With
    ``use_tt`` (top-k / top-p: order statistics of the whole row) the
    ranks gather the ``[B, V]`` logits and run the plain sampler alike."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.sample.ref import sample_logits
    _, idx, _ = _axis(axis)
    v_loc = w_head_local.shape[-1]
    base = idx * v_loc
    pallas = impl == "pallas"
    if use_tt:
        lg = dispatch.matmul(h.float().contiguous(), w_head_local.float(),
                             cfg=cfg, pallas=pallas, gemv=True)
        return sample_logits(all_gather(lg, axis, dim=-1), counts, temp,
                             top_k, top_p, rep, pres, freq, seed, step,
                             use_tt=True)
    score, tok = dispatch.head_sample(
        h, w_head_local, counts[:, base:base + v_loc].contiguous(), temp,
        rep, pres, freq, seed, step, base=base, cfg=cfg, pallas=pallas,
        return_score=True)
    return _combine(score, tok.long() + base, axis)
