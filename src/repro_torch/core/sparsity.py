"""DBB eligibility of parameter-tree leaves and the projection that
applies the density bound to a whole tree (serving-side, no gradient)."""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import DbbConfig
from repro_torch.core.dbb import dbb_project

__all__ = ["dbb_eligible", "apply_dbb_to_tree", "map_with_path", "packable"]

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
                      nnz: Optional[int] = None) -> Any:
    """Every eligible leaf DBB-projected along its second-to-last axis
    (stacked ``[L, K, N]`` leaves one matrix at a time, which bounds the
    transient memory to one layer's worth)."""
    if not cfg.enabled:
        return params
    k = cfg.nnz if nnz is None else nnz
    if k >= cfg.block:
        return params

    def visit(path, leaf):
        if not packable(path, leaf, cfg):
            return leaf
        flat = leaf.reshape(-1, *leaf.shape[-2:])
        out = torch.stack([dbb_project(w, cfg.block, k) for w in flat])
        return out.reshape(leaf.shape)

    return map_with_path(visit, params)
