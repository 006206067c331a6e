"""Gradient compression with error feedback.

The numerics of the round trip a worker's gradient makes through a
compressed all-reduce: "none", "bf16" (a bf16 round trip), or "int8_ef"
(per-tensor symmetric INT8 with an error-feedback accumulator, EF-SGD,
which carries each step's rounding error into the next). On one device
there is no reduction: the round trip is what the optimizer sees. On a
mesh (``specs``: the tree of `dist.sharding.Spec` that cut each leaf)
int8_ef's per-tensor scale is the whole leaf's: the maximum over its
shards (a MAX all-reduce over the axes that split it, one per set of
axes).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from repro_torch.train.tree import tree_map, tree_unzip

__all__ = ["init_ef_state", "compress_grads", "wire_bytes_per_elem"]


def wire_bytes_per_elem(mode: str) -> float:
    return {"none": 4.0, "bf16": 2.0, "int8_ef": 1.0}[mode]


def init_ef_state(params: Any, mode: str) -> Optional[Any]:
    """Zeros like the params (f32) for "int8_ef", else None."""
    if mode != "int8_ef":
        return None
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _q_int8(g: torch.Tensor, amax: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Symmetric per-tensor INT8 quantize → dequantize (``amax``: the
    tensor's max |g| when it is a shard of a larger one)."""
    g32 = g.float()
    if amax is None:
        amax = g32.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return torch.clamp(torch.round(g32 / scale), -127, 127) * scale


def _leaf_amax(targets: Any, specs: Any) -> List[torch.Tensor]:
    """Each leaf's max |t| over its shards, in `tree_map` order."""
    from repro_torch.dist.collectives import reduce_max
    from repro_torch.train.optimizer import _axes
    local: List[Tuple[Tuple[str, ...], torch.Tensor]] = []
    tree_map(lambda t, sp: local.append((_axes(sp, t.ndim),
                                         t.abs().max())), targets, specs)
    out: List[Optional[torch.Tensor]] = [None] * len(local)
    # in first-seen order: the same on every rank (a set is not)
    for ax in dict.fromkeys(a for a, _ in local):
        idx = [i for i, (a, _) in enumerate(local) if a == ax]
        m = torch.stack([local[i][1] for i in idx])
        if ax:
            m = reduce_max(m, ax)
        for j, i in enumerate(idx):
            out[i] = m[j]
    return out


def compress_grads(grads: Any, ef: Optional[Any], mode: str,
                   specs: Any = None) -> Tuple[Any, Optional[Any]]:
    """(the gradients after the round trip, the new error-feedback
    state)."""
    if mode == "none":
        return grads, ef
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).float(), grads), ef
    if mode == "int8_ef":
        targets = tree_map(lambda g, e: g.float() + e, grads, ef)
        amax = None if specs is None else iter(_leaf_amax(targets, specs))

        def one(t):
            sent = _q_int8(t, None if amax is None else next(amax))
            return sent, t - sent
        sent, new_ef = tree_unzip(tree_map(one, targets), 2)
        return sent, new_ef
    raise ValueError(mode)
