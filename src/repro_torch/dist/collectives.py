"""The LM-head cross-entropy, and the collectives of tensor parallelism
for serving and for training on a mesh.

Logits are taken in f32, as in the JAX package. `cross_entropy` picks the
vocab-parallel form inside a training step whose LM head arrives split by
column over a "model" axis (`dist.mesh_ctx.TrainLayout`), the
token-chunked form when the full ``[tokens, V]`` logits would be large,
and the plain dense form otherwise. On a mesh every form's mean is the
global batch's: the masked sums are added over the batch axes before the
division, as the reference's GSPMD graph computes ``_masked_mean``.

Every rank of a live mesh (`dist.mesh_ctx`) holds plain local tensors;
where the reference's shard_map bodies call ``psum`` / ``all_gather`` /
``psum_scatter``, these call ``torch.distributed`` over the mesh axis's
process group. Under gloo, CUDA tensors take all-reduce and broadcast
only, so every collective here is an all-reduce: a gather all-reduces a
zero-filled ``[n, ...]`` buffer holding this rank's block at its index
(x + 0 = x, exact), and a reduce-scatter is an all-reduce and a
``narrow``. Every collective leaves its input as it was.

Serving (no gradient):

  * `all_reduce`: the boundary all-reduce after a row-parallel block,
    issued once. The reference splits it into chunks so that XLA can
    start the first chunk's transfer while the producing GEMM's epilogue
    stores the rest; in eager PyTorch the GEMM has finished before a
    collective is issued, so a chunk would only be one more collective;
  * `vocab_parallel_embed` (below, under training) serves the
    row-sharded embedding gather too: its forward is one all-reduce;
  * `shard_greedy` / `shard_sample`: the vocab-parallel heads — each rank
    reduces its column slice to one (score, global id) pair per row and a
    ``[tp, B]`` gather picks the winner, ties to the lowest global id as
    ``argmax`` takes them; `greedy_vocab_parallel` and `greedy_scatter`
    are the reference's forms for a whole head (column- and row-split on
    the ranks).

Training (Megatron's pairs, as ``torch.autograd.Function``s whose
backward is the collective the forward's use calls for):

  * `copy_to` (identity; backward all-reduce) and `reduce_from`
    (all-reduce; backward identity): the entry and exit of a TP block on a
    replicated stream, and `sum_over`, `reduce_from` over several axes;
  * `gather_partial` (all-gather; backward reduce-scatter) for a gather
    whose consumers are split over the axis, each rank's gradient a share
    of the whole (sequence parallelism's block entry, attention's K/V);
    `gather_replicated` (all-gather; backward this rank's slice) for one
    whose consumer is replicated, every rank's gradient the whole (the
    CE's per-rank logsumexps);
  * `reduce_scatter` (backward all-gather) and `scatter` (this rank's
    slice; backward all-gather): sequence parallelism's block exit and
    entry into the split stream;
  * `scale_grad`: the identity with a scaled gradient.

  On them `vocab_parallel_ce` and `vocab_parallel_embed` (the head split
  by column and the table by row over "model").

`all_gather` is the zero-filled all-reduce described above; it runs on
both backends. A backward runs on the autograd engine's thread, where the
mesh context is not set: each function takes its process group at the
forward call.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.roofline.counts import collective

__all__ = ["dense_ce", "dense_ce_chunked", "cross_entropy",
           "vocab_parallel_ce", "vocab_parallel_embed", "axis_size",
           "all_reduce", "all_gather", "reduce_max",
           "shard_greedy", "shard_sample", "greedy_vocab_parallel",
           "greedy_scatter", "copy_to", "reduce_from", "sum_over",
           "gather_partial", "gather_replicated", "reduce_scatter",
           "scatter", "scale_grad"]

# live logits above this many elements (~1 GB f32) take the chunked form
CHUNK_LOGITS_ABOVE = 1 << 28


def _masked_mean(nll: torch.Tensor, mask: Optional[torch.Tensor],
                 batch_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """The token mean of ``nll`` under ``mask``; with ``batch_axes`` the
    global batch's: the numerator and the count summed over those axes
    before the division."""
    if not batch_axes:
        if mask is None:
            return nll.mean()
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    if mask is None:
        num, den = nll.sum(), torch.full((), float(nll.numel()),
                                         device=nll.device)
    else:
        m = mask.float()
        num, den = (nll * m).sum(), m.sum()
    return sum_over(num, batch_axes) / torch.clamp(
        sum_over(den.detach(), batch_axes), min=1.0)


def _nll(h: torch.Tensor, w: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    logits = h.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - ll


def dense_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None,
             batch_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """Token-mean CE with full ``[.., V]`` logits: h ``[B, S, d]`` · w
    ``[d, V]`` (the mean over the batch axes' ranks with ``batch_axes``)."""
    return _masked_mean(_nll(h, w, labels), mask, batch_axes)


def _chunk_sums(hc: torch.Tensor, w: torch.Tensor, lc: torch.Tensor,
                mc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (_nll(hc, w, lc) * mc).sum(), mc.sum()


def dense_ce_chunked(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     rows: int = 8192,
                     batch_axes: Tuple[str, ...] = ()) -> torch.Tensor:
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
    if batch_axes:
        nll_sum = sum_over(nll_sum, batch_axes)
        m_sum = sum_over(m_sum.detach(), batch_axes)
    return nll_sum / torch.clamp(m_sum, min=1.0)


def vocab_parallel_ce(h: torch.Tensor, w_local: torch.Tensor,
                      labels: torch.Tensor,
                      mask: Optional[torch.Tensor] = None, *,
                      axis: str = "model",
                      batch_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """CE with the head split by column over ``axis``: this rank holds the
    vocab slice ``w_local [d, V/tp]`` (rank i: ids ``[i·V/tp, (i+1)·V/tp)``)
    and the rows ``h [B, S, d]`` whole. Its slice's logsumexp and, where
    the label falls in the slice, the label's logit combine over the ranks
    (a ``[tp, B, S]`` gather, a sum), so ``[tokens, V]`` logits never
    exist. The loss is the same on every rank of ``axis``; its gradient
    for ``h`` is this rank's slice's share, so ``h`` enters through
    `copy_to` (a replicated stream) or `gather_partial` (a
    sequence-split one), which add the shares."""
    line = _line(axis)
    idx = line[1]
    v_loc = w_local.shape[-1]
    logits = h.float() @ w_local.float()
    lse_loc = torch.logsumexp(logits, dim=-1)
    lse = torch.logsumexp(_GatherReplicated.apply(lse_loc, line, None),
                          dim=0)
    lab = labels.long() - idx * v_loc
    in_range = (lab >= 0) & (lab < v_loc)
    ll_loc = torch.gather(logits, -1, lab.clamp(0, v_loc - 1)[..., None])[
        ..., 0]
    ll = _ReduceFrom.apply(
        torch.where(in_range, ll_loc, torch.zeros((), device=h.device)),
        line)
    return _masked_mean(lse - ll, mask, batch_axes)


def cross_entropy(hidden: torch.Tensor, w_head: torch.Tensor,
                  labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LM-head CE dispatcher. Inside a training step on a mesh
    (`dist.mesh_ctx.train_layout`): vocab-parallel where the head arrives
    split by column ("head" in the layout's ``split``; the reference's
    test: a live model axis over 1 that divides V), the hidden rows
    gathered along a sequence-parallel stream first; else the forms below
    on the whole head, each a mean over the layout's batch axes. Elsewhere: token-chunked when the full logits tensor would pass
    ``CHUNK_LOGITS_ABOVE`` elements, plain dense otherwise."""
    from repro_torch.dist.mesh_ctx import train_layout
    lay = train_layout()
    axes: Tuple[str, ...] = ()
    if lay is not None:
        axes = lay.batch_axes
        # the forward leaves a sequence-parallel stream split: its rows
        # are shorter than the labels'
        sp = hidden.shape[1] != labels.shape[1]
        if "head" in lay.split:
            h = (gather_partial(hidden, "model", 1) if sp
                 else copy_to(hidden, "model"))
            return vocab_parallel_ce(h, w_head, labels, mask,
                                     batch_axes=axes)
        if sp:
            hidden = gather_replicated(hidden, "model", 1)
    if labels.numel() * w_head.shape[-1] > CHUNK_LOGITS_ABOVE:
        return dense_ce_chunked(hidden, w_head, labels, mask,
                                batch_axes=axes)
    return dense_ce(hidden, w_head, labels, mask, batch_axes=axes)


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


def _line(axis: str) -> Tuple[Any, int, int]:
    """(the process group of ``axis`` or None, this rank's index on it,
    its size), taken from the live mesh."""
    mesh = _live(axis)
    return mesh.groups.get(axis), mesh.index[axis], mesh.shape[axis]


def axis_size(name: str = "model") -> int:
    """Size of the live mesh's axis ``name``; raises outside a mesh."""
    return int(_live(name).shape[name])


def all_reduce(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``, in x's dtype (a new
    tensor; every rank gets the same bits)."""
    return _sum(x, _line(axis)[0])


def all_gather(x: torch.Tensor, axis: str = "model",
               dim: Optional[int] = None) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``: stacked ``[tp, *x.shape]``, or,
    with ``dim``, concatenated along it (rank order = index order)."""
    return _stack(x, _line(axis), dim)


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
    _, idx, _ = _line(axis)
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
    _, idx, _ = _line(axis)
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


def greedy_vocab_parallel(hidden: torch.Tensor, w_head: torch.Tensor, *,
                          impl: str = "xla", cfg=None, axis: str = "model"
                          ) -> torch.Tensor:
    """The reference's vocab-parallel greedy head for a whole head
    ``[d, V]``: each rank takes its column slice, and `shard_greedy` runs
    the head GEMV on it and the scalar combine; ``hidden [B, d]`` is the
    last position's activations. The ranks' tokens are equal."""
    _, idx, tp = _line(axis)
    v = w_head.shape[-1]
    if v % tp:
        raise ValueError(f"vocab {v} does not divide the {axis} axis ({tp})")
    v_loc = v // tp
    return shard_greedy(hidden, w_head[:, idx * v_loc:(idx + 1) * v_loc],
                        impl=impl, cfg=cfg, axis=axis)


def greedy_scatter(hidden: torch.Tensor, w_head: torch.Tensor,
                   axis: str = "model") -> torch.Tensor:
    """The reference's greedy head for a head split along d (a ZeRO'd head
    or a row-split tied table): each rank multiplies its d slice of
    ``hidden [B, d]`` by its row slice of ``w_head [d, V]`` into partial
    ``[B, V]`` logits, a reduce-scatter leaves it the sums of its vocab
    slice ``[B, V/tp]``, and the scalar combine picks the token."""
    line = _line(axis)
    tp = line[2]
    d, v = w_head.shape
    if d % tp or v % tp:
        raise ValueError(f"head {tuple(w_head.shape)} does not divide the "
                         f"{axis} axis ({tp})")
    hl = _own(hidden, line, hidden.ndim - 1)
    wl = _own(w_head, line, 0)
    partial = hl.float() @ wl.float()
    return _greedy_combine(
        _own(_sum(partial, line[0], "reduce-scatter"), line, -1), axis)


def reduce_max(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axes`` (no
    gradient; a new tensor)."""
    import torch.distributed as dist
    y = x.detach().clone(memory_format=torch.contiguous_format)
    for a in axes:
        group = _line(a)[0]
        if group is not None:
            collective("all-reduce", y, "reduce_max")
            dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


# ---------------------------------------------------------------------------
# training collectives: Megatron's pairs with their backward rules
# ---------------------------------------------------------------------------

def _sum(x: torch.Tensor, group, kind: str = "all-reduce",
         payload: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A new tensor: the sum of ``x`` over ``group`` (x itself copied when
    the group is None). A step counter (`roofline.counts`) counts it as a
    collective of the logical ``kind`` it implements, whose operand is
    ``payload`` (default ``x``): an all-gather's is the rank's block, not
    the zero-filled buffer the all-reduce carries."""
    import torch.distributed as dist
    y = x.clone(memory_format=torch.contiguous_format)
    if group is not None:
        collective(kind, x if payload is None else payload)
        dist.all_reduce(y, group=group)
    return y


def _stack(x: torch.Tensor, line, dim: Optional[int]) -> torch.Tensor:
    """Every rank's ``x``: stacked ``[n, ...]``, or concatenated along
    ``dim`` (the zero-filled all-reduce)."""
    group, idx, n = line
    buf = torch.zeros((n, *x.shape), dtype=x.dtype, device=x.device)
    buf[idx] = x
    out = _sum(buf, group, "all-gather", x)
    return out if dim is None else torch.cat(out.unbind(0), dim=dim)


def _own(x: torch.Tensor, line, dim: Optional[int]) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (its row of a stacked
    ``[n, ...]`` when None)."""
    _, idx, n = line
    if dim is None:
        return x[idx]
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size).contiguous()


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        return _sum(x, line[0])

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        ctx.group = line[0]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.line, ctx.dim = line, dim
        return _stack(x, line, dim)

    @staticmethod
    def backward(ctx, g):
        return (_own(_sum(g, ctx.line[0], "reduce-scatter"), ctx.line,
                     ctx.dim), None, None)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.line, ctx.dim = line, dim
        return _stack(x, line, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.line, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.line, ctx.dim = line, dim
        return _own(_sum(x, line[0], "reduce-scatter"), line, dim)

    @staticmethod
    def backward(ctx, g):
        return _stack(g.contiguous(), ctx.line, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line, dim):
        ctx.line, ctx.dim = line, dim
        return _own(x, line, dim)

    @staticmethod
    def backward(ctx, g):
        return _stack(g.contiguous(), ctx.line, ctx.dim), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def copy_to(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``axis`` (a replicated
    stream or weight entering a block whose ranks each give a share)."""
    return _CopyTo.apply(x, _line(axis))


def reduce_from(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The sum of ``x`` over ``axis``; the gradient passed through (the
    exit of a row-parallel block into a replicated stream)."""
    return _ReduceFrom.apply(x, _line(axis))


def sum_over(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """`reduce_from` over each of ``axes`` in turn (the sum over their
    product)."""
    for a in axes:
        x = _ReduceFrom.apply(x, _line(a))
    return x


def gather_partial(x: torch.Tensor, axis: str = "model",
                   dim: int = 1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``; backward: the
    gradient summed over ``axis``, this rank's block kept (the consumers
    are split over the axis, each rank's gradient a share)."""
    return _GatherPartial.apply(x, _line(axis), dim)


def gather_replicated(x: torch.Tensor, axis: str = "model",
                      dim: Optional[int] = 1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` (stacked ``[n, ...]``
    when None); backward: this rank's block of the gradient (the consumer
    is replicated, every rank's gradient the whole)."""
    return _GatherReplicated.apply(x, _line(axis), dim)


def reduce_scatter(x: torch.Tensor, axis: str = "model",
                   dim: int = 1) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``axis``;
    backward: the blocks' gradients gathered."""
    return _ReduceScatter.apply(x, _line(axis), dim)


def scatter(x: torch.Tensor, axis: str = "model",
            dim: int = 1) -> torch.Tensor:
    """This rank's block of the replicated ``x`` along ``dim``; backward:
    the blocks' gradients gathered."""
    return _Scatter.apply(x, _line(axis), dim)


def scale_grad(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x`` as it is; its gradient times ``c``."""
    return _ScaleGrad.apply(x, c)


def vocab_parallel_embed(table_local: torch.Tensor, tokens: torch.Tensor,
                         dtype: torch.dtype, axis: str = "model"
                         ) -> torch.Tensor:
    """The row-split embedding gather (a TP shard body's, or a training
    step's): this rank's table holds one contiguous vocab slice; in-slice
    tokens gather, the others give zeros, and one f32 all-reduce over
    ``axis`` assembles the rows (exactly: one term is not zero). The rows
    are replicated over the axis; each rank's table gradient is its own
    rows'. The ``[V, d]`` table is never gathered."""
    _, idx, _ = line = _line(axis)
    v_loc = table_local.shape[0]
    loc = tokens.long() - idx * v_loc
    in_range = (loc >= 0) & (loc < v_loc)
    emb = table_local[loc.clamp(0, v_loc - 1)].float()
    emb = torch.where(in_range[..., None], emb,
                      torch.zeros((), device=emb.device))
    return _ReduceFrom.apply(emb, line).to(dtype)
