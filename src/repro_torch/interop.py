"""Parameter trees from the JAX package into the port, without JAX.

`params_from_numpy` takes the reference's tree as nested dicts whose
leaves are arrays (numpy, or anything ``np.asarray`` reads) and packed
leaves read by attribute — ``values``, ``bitmask``, ``scale``, ``block``,
``nnz``, ``k_dim``, ``bits``, ``group`` (and ``indices`` when present) —
and INT8 weights read by attribute — ``q``, ``scale`` (the reference's
``QuantizedWeight``) — and returns the same tree of torch tensors, port
`DbbWeight`s and port `QuantizedWeight`s. `shard_from_numpy` returns one
TP rank's part of that tree instead (the serving wrap's specs).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.dbb import DbbWeight
from repro_torch.core.quant import QuantizedWeight

__all__ = ["params_from_numpy", "tensor_from_numpy", "shard_from_numpy"]


def tensor_from_numpy(a: Any, device="cpu") -> torch.Tensor:
    """A torch copy of an array; uint32 (the reference's bitmask) becomes
    int32 with the same bytes."""
    arr = np.asarray(a)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _is_packed(leaf: Any) -> bool:
    return all(hasattr(leaf, f) for f in ("values", "bitmask", "block",
                                          "nnz", "k_dim"))


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """The port's tree for a reference parameter tree (see module doc)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return QuantizedWeight(q=tensor_from_numpy(tree.q, device),
                               scale=tensor_from_numpy(tree.scale, device))
    if _is_packed(tree):
        def opt(a):
            return None if a is None else tensor_from_numpy(a, device)
        return DbbWeight(
            values=tensor_from_numpy(tree.values, device),
            indices=opt(getattr(tree, "indices", None)),
            bitmask=tensor_from_numpy(tree.bitmask, device),
            scale=opt(getattr(tree, "scale", None)),
            block=int(tree.block), nnz=int(tree.nnz), k_dim=int(tree.k_dim),
            bits=int(getattr(tree, "bits", 8)),
            group=int(getattr(tree, "group", 0)))
    return tensor_from_numpy(tree, device)


def shard_from_numpy(tree: Any, cfg, mesh, device="cpu") -> Any:
    """This rank's shard of a reference tree under the TP serving specs
    (`dist.sharding.param_specs` without ZeRO), cut before it moves to
    ``device``."""
    from repro_torch.dist.sharding import param_specs, shard_tree
    full = params_from_numpy(tree)
    shard = shard_tree(full, param_specs(full, mesh, cfg,
                                         fsdp_min_shard_elems=None), mesh)
    return _to(shard, device)


def _to(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, DbbWeight):
        return tree.map(lambda a: a.to(device))
    if isinstance(tree, QuantizedWeight):
        return QuantizedWeight(q=tree.q.to(device), scale=tree.scale.to(device))
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree
