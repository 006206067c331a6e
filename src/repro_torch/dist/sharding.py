"""Partition specs of parameter, optimizer-state, cache and batch trees,
and `shard_tree`, which cuts one rank's part out of a tree.

The rules are the reference's (``repro.dist.sharding``), term for term:

  * Megatron TP over the "model" axis — column-parallel up-projections
    (q/k/v_proj, wi, wg: last dim), row-parallel down-projections
    (o_proj, wo: second-to-last dim), vocab-parallel embedding rows and
    LM-head columns, expert-parallel MoE stacks (the E dim).
  * ZeRO/FSDP over the batch axes ("pod", "data"): a leaf of at least
    ``FSDP_MIN_SHARD_ELEMS`` elements also shards one free dim.
  * Every rule is divisibility-guarded: a dim that does not divide the
    axis product stays whole instead of raising.
  * ``cfg.parallel == "dp"``: the model axis carries no TP and joins ZeRO.

A packed leaf (`core.dbb.DbbWeight`) takes its parent's rule plane by
plane: ``values`` / ``indices`` / ``bitmask`` keep N last and the
compressed K second to last, so column rules split their last dim and row
rules their second to last — in whole DBB blocks (``bitmask`` rows are
blocks, ``values`` rows block-major slots, so the unit is ``nnz · tp``);
the per-channel ``scale [N]`` follows N on column leaves and stays whole
on row leaves. A w4 leaf's group-scale plane ``[K//G, N]`` is not in the
row rule either (the reference's), so a row-split w4 leaf would keep
every group's scales against a K slice: the serving wrap refuses such
trees (`serve.engine.tp_serve_reason`).

A spec is a `Spec`: one entry per leading dim — an axis name, a tuple of
names, or None — and a tree of specs mirrors its tree (a `DbbWeight` of
specs for a packed leaf). Specs are pure data: only ``mesh.shape`` (axis →
size) and ``mesh.axis_names`` are read, so any object with those two
serves, as the reference's fake meshes do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.dbb import DbbWeight
from repro_torch.core.quant import QuantizedWeight
from repro_torch.dist.mesh_ctx import data_axes_of

__all__ = ["Spec", "FSDP_MIN_SHARD_ELEMS", "param_specs",
           "opt_state_specs_like", "cache_specs", "serve_cache_specs",
           "batch_specs", "zero_spec", "tp_spec_violations", "shard_tree",
           "w4_row_leaves"]

# leaves below this many elements stay replicated under ZeRO/FSDP (8M
# elements ≈ 32 MB f32)
FSDP_MIN_SHARD_ELEMS = 1 << 23

_COLUMN = {"q_proj", "k_proj", "v_proj", "wi", "wg"}
_ROW = {"o_proj", "wo"}
_PACKED_FIELDS = {"values", "indices", "bitmask", "scale"}
_NODES = (DbbWeight, QuantizedWeight)


class Spec(tuple):
    """A partition spec: ``Spec("model", None)`` splits dim 0 over the
    model axis and keeps dim 1 whole; missing trailing entries are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _fields(node) -> List[str]:
    return [f.name for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), (torch.Tensor, Spec))]


def _map(fn: Callable, tree: Any, names: Tuple[str, ...] = ()) -> Any:
    """``fn(names, leaf)`` over a nested dict tree whose packed and INT8
    nodes map their tensor planes by field name."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, _NODES):
        return dataclasses.replace(tree, **{
            f: fn(names + (f,), getattr(tree, f)) for f in _fields(tree)})
    return fn(names, tree)


def _flatten(tree: Any, names: Tuple[str, ...] = ()
             ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(names, leaf) pairs, dict keys sorted as jax flattens them."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _flatten(tree[k], names + (str(k),))]
    if isinstance(tree, _NODES):
        return [(names + (f,), getattr(tree, f)) for f in _fields(tree)]
    return [(names, tree)]


def _ndim(leaf) -> int:
    return len(leaf.shape) if hasattr(leaf, "shape") else 0


def _axprod(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _batch_axes(mesh, batch: int):
    """Longest prefix of the batch axes whose product divides ``batch``
    (None when even the first does not)."""
    daxes = data_axes_of(mesh)
    for k in range(len(daxes), 0, -1):
        if batch % _axprod(mesh, daxes[:k]) == 0:
            return daxes[:k] if k > 1 else daxes[0]
    return None


def zero_spec(spec: Spec, shape: Tuple[int, ...], mesh,
              min_elems: Optional[int] = FSDP_MIN_SHARD_ELEMS,
              axes: Optional[Tuple[str, ...]] = None) -> Spec:
    """ZeRO/FSDP batch-axis sharding added to one leaf's spec: leaves
    below ``min_elems`` (or ``min_elems=None``) are untouched; otherwise
    the free dims are scanned from the last and the first that the
    longest suffix of ``axes`` (default: the mesh's batch axes) divides
    takes that suffix."""
    if min_elems is None:
        return spec
    size = 1
    for s in shape:
        size *= s
    if size < min_elems:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        for a in (e,) if isinstance(e, str) else (e or ()):
            used.add(a)
    cand = tuple(a for a in (axes if axes is not None else data_axes_of(mesh))
                 if a in mesh.axis_names and a not in used)
    if not cand:
        return spec
    for dim in reversed(range(len(shape))):
        if entries[dim] is not None:
            continue
        for k in range(len(cand)):
            sub = cand[k:]
            if shape[dim] % _axprod(mesh, sub) == 0 and _axprod(mesh, sub) > 1:
                entries[dim] = sub if len(sub) > 1 else sub[0]
                return Spec(*entries)
    return spec


def param_specs(params: Any, mesh, cfg: ModelConfig,
                fsdp_min_shard_elems: Optional[int] = FSDP_MIN_SHARD_ELEMS
                ) -> Any:
    """The spec tree mirroring ``params``."""
    tp = mesh.shape["model"] if "model" in mesh.axis_names else 1
    tp_on = tp > 1 and cfg.parallel != "dp" and cfg.family != "cnn"
    zero_axes = data_axes_of(mesh)
    if cfg.parallel == "dp" and "model" in mesh.axis_names:
        zero_axes = zero_axes + ("model",)

    def leaf_spec(names, leaf):
        nd = _ndim(leaf)
        if nd == 0:
            return Spec()
        nameset = set(names)
        field = names[-1] if names else ""
        shape = tuple(leaf.shape)
        spec = [None] * nd
        if tp_on:
            if "experts" in nameset and nd >= 3:
                if shape[-3] % tp == 0:
                    spec[-3] = "model"
            elif "embed" in nameset and field == "table":
                if shape[0] % tp == 0:
                    spec[0] = "model"          # vocab-parallel rows
            elif "lm_head" in nameset:
                if field in {"w"} | _PACKED_FIELDS and shape[-1] % tp == 0:
                    spec[-1] = "model"         # vocab-parallel columns
            elif nameset & _COLUMN:
                if (field in {"w", "b"} | _PACKED_FIELDS
                        and shape[-1] % tp == 0):
                    spec[-1] = "model"
            elif nameset & _ROW:
                if field == "w" and nd >= 2 and shape[-2] % tp == 0:
                    spec[-2] = "model"
                elif field in ("values", "indices", "bitmask") and nd >= 2:
                    # whole DBB blocks per shard: bitmask rows are blocks,
                    # values / indices rows block-major slots
                    unit = tp if field == "bitmask" else cfg.dbb.nnz * tp
                    if shape[-2] % unit == 0:
                        spec[-2] = "model"
        return zero_spec(Spec(*spec), shape, mesh,
                         min_elems=fsdp_min_shard_elems, axes=zero_axes)

    return _map(leaf_spec, params)


def _has_model(spec) -> bool:
    for e in tuple(spec):
        if "model" in ((e,) if isinstance(e, str) else tuple(e or ())):
            return True
    return False


def tp_spec_violations(params: Any, pspecs: Any) -> List[str]:
    """TP-eligible weight leaves whose spec did NOT take the model axis
    (the divisibility fallback kept them whole), as "a/b/field" paths,
    plus any row-parallel bias. The TP wrap's boundary all-reduces assume
    every such leaf is split (a whole row weight would be summed tp
    times), so any gap keeps the wrap off."""
    specs = dict(_flatten(pspecs))
    out = []
    for names, leaf in _flatten(params):
        if _ndim(leaf) == 0:
            continue
        nameset = set(names)
        field = names[-1] if names else ""
        if nameset & _ROW:
            if field == "b":
                out.append("/".join(names) + " (row-parallel bias)")
                continue
            eligible = field in ("w", "values", "indices", "bitmask")
        elif nameset & _COLUMN:
            eligible = field in {"w", "b"} | _PACKED_FIELDS
        elif "embed" in nameset:
            eligible = field == "table"
        elif "lm_head" in nameset:
            eligible = field in {"w"} | _PACKED_FIELDS
        else:
            eligible = False
        if eligible and not _has_model(specs.get(names, Spec())):
            out.append("/".join(names))
    return out


def w4_row_leaves(params: Any, names: Tuple[str, ...] = ()) -> List[str]:
    """Paths of the bits=4 packed leaves under a row-parallel projection
    (o_proj, wo): the row rule splits their K planes and keeps their
    ``[K//G, N]`` group scales whole."""
    if isinstance(params, dict):
        return [p for k in sorted(params)
                for p in w4_row_leaves(params[k], names + (str(k),))]
    if (isinstance(params, DbbWeight) and params.bits == 4
            and set(names) & _ROW):
        return ["/".join(names)]
    return []


def _pad(spec, nd: int) -> Tuple:
    t = tuple(spec)
    return t + (None,) * (nd - len(t))


def opt_state_specs_like(opt_state: Dict, params: Any, pspecs: Any,
                         mesh) -> Dict:
    """Specs of an optimizer-state tree from the param specs: a moment of
    its parameter's shape copies the spec; Adafactor's factored ``vr``
    (shape[:-1]) keeps the leading entries and ``vc`` (shape[:-2] +
    shape[-1:]) the leading and the last; anything else replicates."""
    specs = dict(_flatten(pspecs))
    by_path = {n: (leaf, specs.get(n, Spec()))
               for n, leaf in _flatten(params)}

    def factored(x):
        return (isinstance(x, dict) and ("vr" in x or "v" in x)
                and all(hasattr(v, "shape") for v in x.values()))

    def visit(names, x):
        hit = by_path.get(names)
        if factored(x):
            if hit is None:
                return {k: Spec() for k in x}
            leaf, spec = hit
            full = _pad(spec, _ndim(leaf))
            out = {}
            if "vr" in x:
                out["vr"] = Spec(*full[:-1])
            if "vc" in x:
                out["vc"] = Spec(*(full[:-2] + full[-1:]))
            if "v" in x:
                out["v"] = Spec(*full)
            return out
        if isinstance(x, dict):
            return {k: visit(names + (str(k),), v) for k, v in x.items()}
        if isinstance(x, _NODES):
            return dataclasses.replace(x, **{
                f: visit(names + (f,), getattr(x, f)) for f in _fields(x)})
        if _ndim(x) == 0:
            return Spec()
        if hit is not None and tuple(hit[0].shape) == tuple(x.shape):
            return hit[1]
        return Spec()

    return {k: visit((), v) for k, v in opt_state.items()}


def cache_specs(cfg: ModelConfig, mesh, batch: int, seq: int) -> Dict:
    """Specs of the decode cache of ``cfg`` (the keys of `init_cache`): the
    batch dim over the batch axes, the rest whole."""
    from repro_torch.models import registry      # lazy: import cycle
    ba = _batch_axes(mesh, batch)
    cache = registry.init_cache(cfg, batch, seq, device="meta")

    def visit(names, leaf):
        if names and names[-1] == "length":
            return Spec(ba)
        return Spec(None, ba, *([None] * (_ndim(leaf) - 2)))

    return _map(visit, cache)


def serve_cache_specs(cache: Any, mesh) -> Any:
    """Specs of a serving KV cache under the TP wrap: KV heads split over
    "model" — dim 3 of the contiguous ``k / v [L, B, S, Hkv, D]`` and of the
    paged ``k_pages / v_pages [L, P, page, Hkv, D]`` — so each rank holds
    its own heads' cache; the replicated block tables index rank-local
    pools of local heads. Bookkeeping (length, start, block_table) stays
    whole."""
    tp = mesh.shape["model"] if "model" in mesh.axis_names else 1

    def visit(names, leaf):
        field = names[-1] if names else ""
        nd = _ndim(leaf)
        if (field in ("k", "v", "k_pages", "v_pages") and tp > 1
                and nd >= 4 and leaf.shape[3] % tp == 0):
            return Spec(None, None, None, "model", *([None] * (nd - 4)))
        return Spec(*([None] * nd))

    return _map(visit, cache)


def batch_specs(cfg: ModelConfig, mesh, global_batch: int, seq: int
                ) -> Dict[str, Spec]:
    """Specs of every step-input key: the batch dim over the batch axes,
    sequence and feature dims whole."""
    ba = _batch_axes(mesh, global_batch)
    return {"tokens": Spec(ba, None), "labels": Spec(ba, None),
            "loss_mask": Spec(ba, None), "embeds": Spec(ba, None, None),
            "prefix_embeds": Spec(ba, None, None),
            "images": Spec(ba, None, None, None)}


def _slice(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (the first axis of a tuple
    entry major, as a NamedSharding lays it out)."""
    for dim, e in enumerate(tuple(spec)):
        axes = (e,) if isinstance(e, str) else tuple(e or ())
        n, idx = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + mesh.index[a]
        if n > 1:
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"divide {axes} ({n})")
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
    return t.contiguous()


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """This rank's part of ``tree`` under the spec tree ``specs`` (from
    `param_specs` / `serve_cache_specs`): every tensor cut to its block,
    on the device it is on — call it before the tree moves to the card so
    only the shard crosses. A packed leaf whose bitmask rows were split
    (a row-parallel K split) carries its local ``k_dim``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, _NODES):
        out = dataclasses.replace(tree, **{
            f: _slice(getattr(tree, f), getattr(specs, f), mesh)
            for f in _fields(tree)})
        if isinstance(out, DbbWeight) and out.bitmask.shape[-2] != \
                tree.bitmask.shape[-2]:
            out = dataclasses.replace(
                out, k_dim=out.bitmask.shape[-2] * out.block)
        return out
    if isinstance(tree, torch.Tensor):
        return _slice(tree, specs, mesh)
    return tree
