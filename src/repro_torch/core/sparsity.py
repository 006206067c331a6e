"""DBB-sparse training and the tree-level projection (paper §V-A).

The paper trains DBB models with amplitude-based pruning; as in the JAX
package this is projected training: the forward pass sees the
DBB-projected weight, the backward pass is straight-through (the dense
master weights receive the gradient, so pruned entries can come back
while the bound anneals), and the density bound shrinks from dense to the
target nnz over a ramp.

Also here: which parameter-tree leaves are DBB-eligible, and the
projection of a whole tree (with or without the straight-through
gradient; serving projects without one).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import DbbConfig
from repro_torch.core.dbb import dbb_project

__all__ = ["ste_dbb", "dbb_schedule_nnz", "dbb_eligible",
           "apply_dbb_to_tree", "tree_sparsity_report", "map_with_path",
           "packable"]


class _SteDbb(torch.autograd.Function):
    """Forward: `dbb_project`. Backward: the upstream gradient, unchanged."""

    @staticmethod
    def forward(ctx, w, block, nnz):
        return dbb_project(w, block, nnz)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def ste_dbb(w: torch.Tensor, block: int, nnz: int) -> torch.Tensor:
    """The DBB projection of ``w [K, N]`` with a straight-through gradient:
    the dense master weights receive the full upstream gradient."""
    return _SteDbb.apply(w, block, nnz)


def dbb_schedule_nnz(cfg: DbbConfig, step: int, start: int, ramp: int) -> int:
    """Anneal the density bound: dense until ``start``, then shrink the
    per-block nnz linearly from ``block`` to ``cfg.nnz`` over ``ramp``
    steps."""
    if not cfg.enabled:
        return cfg.block
    if ramp <= 0:
        return cfg.nnz if step >= start else cfg.block
    frac = min(max((step - start) / ramp, 0.0), 1.0)
    nnz = round(cfg.block - frac * (cfg.block - cfg.nnz))
    return int(max(cfg.nnz, min(cfg.block, nnz)))


# Param-name policy: which leaves are DBB-able — the same patterns as the
# JAX package's, over the same parameter names (wi/wg/wo mlp, q/k/v/o
# projections, expert stacks).
_DBB_FAMILY_PATTERNS: Dict[str, Tuple[str, ...]] = {
    "mlp": (r"\bmlp\b.*\bw[igo]\b", r"channel_mix.*\bw[kvr]\b"),
    "attn_proj": (r"\battn\b.*\b[qkvo]_proj\b", r"time_mix.*\b[rkvgo]_proj\b",
                  r"\bmamba\b.*\b(in_proj|out_proj)\b"),
    "expert": (r"\bexperts?\b.*\bw[igo]\b",),
    "lm_head": (r"\blm_head\b",),
    "conv": (r"\bconv\d*\b.*\bw\b", r"\bfc\b.*\bw\b"),
}


def dbb_eligible(path_s: str, cfg: DbbConfig) -> bool:
    # bias vectors (leaf "b") are never packed
    if path_s.rsplit("/", 1)[-1] == "b":
        return False
    for fam in cfg.apply_to:
        for pat in _DBB_FAMILY_PATTERNS.get(fam, ()):
            if re.search(pat, path_s.replace("/", " ")):
                return True
    return False


def map_with_path(fn, tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over a nested dict tree; paths join keys by "/"."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def packable(path: str, leaf: Any, cfg: DbbConfig) -> bool:
    """A float tensor of rank ≥ 2 on an eligible path whose K (second to
    last axis) divides the block."""
    return (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
            and leaf.is_floating_point() and dbb_eligible(path, cfg)
            and leaf.shape[-2] % cfg.block == 0)


def apply_dbb_to_tree(params: Any, cfg: DbbConfig,
                      nnz: Optional[int] = None,
                      straight_through: bool = True) -> Any:
    """Every eligible leaf DBB-projected along its second-to-last axis
    (stacked ``[L, K, N]`` leaves one matrix at a time, which bounds the
    transient memory to one layer's worth). ``straight_through`` projects
    through `ste_dbb`, so a loss on the result differentiates into
    ``params``; ``False`` projects with no gradient (serving, and the
    train step, which projects once outside its gradient graph)."""
    if not cfg.enabled:
        return params
    k = cfg.nnz if nnz is None else nnz
    if k >= cfg.block:
        return params
    proj = ste_dbb if straight_through else dbb_project

    def visit(path, leaf):
        if not packable(path, leaf, cfg):
            return leaf
        flat = leaf.reshape(-1, *leaf.shape[-2:])
        out = torch.stack([proj(w, cfg.block, k) for w in flat])
        return out.reshape(leaf.shape)

    if straight_through:
        return map_with_path(visit, params)
    with torch.no_grad():
        return map_with_path(visit, params)


def tree_sparsity_report(params: Any, cfg: DbbConfig) -> Dict[str, float]:
    """The zero fraction of every eligible float leaf of rank ≥ 2 (for
    logs and Table I), keyed by path, in the JAX package's leaf order
    (dict keys sorted at every level)."""
    report: Dict[str, float] = {}

    def visit(path, leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
                and leaf.is_floating_point() and dbb_eligible(path, cfg)):
            report[path] = float((leaf == 0).float().mean())
        return leaf

    map_with_path(visit, params)
    return {k: report[k] for k in sorted(report, key=lambda p: p.split("/"))}
