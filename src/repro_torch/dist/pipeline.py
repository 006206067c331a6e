"""GPipe-style microbatch pipeline over one mesh axis (the reference's
``repro.dist.pipeline``).

`stack_stages` splits a stacked layer tree ``[L, ...]`` into S contiguous
stages ``[S, L/S, ...]``; `pipeline_forward` runs M microbatches through
the S stages, one per rank of the axis: at tick t, stage s processes
microbatch t - s and hands its output to stage s + 1. M + S - 1 ticks;
the classic (S - 1) / M bubble.

Each rank holds its own stage (``[1, L/S, ...]``, as `dist.sharding`'s
``shard_tree`` cuts ``[S, ...]`` over the axis). The reference's
``ppermute`` becomes one all-reduce a tick of a zero-filled ``[S, ...]``
buffer, rank s writing its output at s + 1 (gloo on CUDA tensors has no
send / receive; x + 0 = x, so the hand-off is exact). The reference
differentiates the pipeline nowhere; neither does this (a forward).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.train.tree import tree_map

__all__ = ["stack_stages", "pipeline_forward"]


def stack_stages(stacked: Any, n_stages: int) -> Any:
    """``[L, ...]`` layer stacks → ``[S, L/S, ...]`` stage stacks (every
    tensor of a nested dict tree)."""
    def re(a):
        l = a.shape[0]
        if l % n_stages:
            raise ValueError(f"{l} layers do not split into {n_stages} "
                             "stages")
        return a.reshape(n_stages, l // n_stages, *a.shape[1:])
    return tree_map(re, stacked)


def pipeline_forward(stage_local: Any, x: torch.Tensor,
                     stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     axis: str = "pod") -> torch.Tensor:
    """Run the microbatches ``x [M, B, ...]`` (the same on every rank)
    through the stages, this rank's being ``stage_local`` (``[1, ...]``
    slices of the stage stack), with ``stage_fn(stage_weights, act)`` per
    stage. Returns ``[M, B, ...]`` on every rank, equal (up to summation
    order) to running every layer in turn on one device."""
    from repro_torch.dist.collectives import all_reduce
    from repro_torch.dist.mesh_ctx import current_mesh
    mesh = current_mesh()
    s_total = mesh.shape[axis]
    sidx = mesh.index[axis]
    m_total = x.shape[0]
    ws = tree_map(lambda a: a[0], stage_local)
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(m_total + s_total - 1):
        m = t - sidx                       # this stage's microbatch id
        inp = x[min(max(m, 0), m_total - 1)] if sidx == 0 else buf
        y = stage_fn(ws, inp)
        if 0 <= m < m_total and sidx == s_total - 1:
            outs[m] = y
        hand = torch.zeros((s_total, *y.shape), dtype=y.dtype,
                           device=y.device)
        if sidx + 1 < s_total:
            hand[sidx + 1] = y
        buf = all_reduce(hand, axis)[sidx]
    # only the last stage holds real outputs; the sum replicates them
    if sidx != s_total - 1:
        outs = torch.zeros_like(outs)
    return all_reduce(outs, axis)
