"""Session-wide mesh context over `torch.distributed` process groups.

The reference keeps a live ``jax.sharding.Mesh`` in a contextvar that
model code reads at trace time. Here every rank is one process holding
its shard as plain local tensors, and a `Mesh` is the rank's view of the
device grid: the axis names ``("data", "model")``, each axis's size, this
rank's coordinate on each axis, the process group of each axis (the ranks
that share this rank's other coordinates) and the backend. Collectives in
`repro_torch.dist.collectives` run over ``mesh.groups[axis]``.

The backend is the caller's explicit choice: ``"nccl"`` when each rank
has its own card, ``"gloo"`` for the CPU and for ranks that share one
card (NCCL refuses two ranks on one device). `make_mesh` needs the default
group initialised (``torch.distributed.init_process_group``) and says so
if it is not; nothing here picks a backend or an address for the caller.

``shard_tp_ctx(tp)`` marks the dynamic extent of a TP shard body: the
serving engine enters it around every step it runs under its TP wrap, so
model code (`embed_apply`, attention's ``o_proj``, `mlp_apply`, the heads)
knows its operands are per-shard slices whose partial results need the
boundary collectives.

The reference's ``shard_hint`` (a GSPMD sharding hint) is read only by
its training graph and waits for that slice; ``repro.dist.compat`` is a
shim for jax's ``shard_map`` spelling and has no counterpart.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional, Tuple

__all__ = ["Mesh", "make_mesh", "make_smoke_mesh", "use_mesh",
           "current_mesh", "data_axes_of", "axis_size", "shard_tp_ctx",
           "shard_tp"]

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a ``data × model`` grid of ranks: ``shape`` maps
    each axis to its size, ``index`` to this rank's coordinate, ``groups``
    to the process group of the ranks on this rank's line along the axis
    (None where the axis has size 1: no collective runs over it).
    Rank r sits at ``(r // model, r % model)``: the model axis is the
    fastest, as in the reference's row-major ``jax.make_mesh``."""
    shape: Dict[str, int]
    index: Dict[str, int]
    groups: Dict[str, Any]
    backend: str
    axis_names: Tuple[str, ...] = AXES


def make_mesh(data: int, model: int, *, backend: str) -> Mesh:
    """The mesh of ``data × model`` ranks over the initialised default
    group (its world size must be ``data · model``). Every rank calls it
    with the same arguments: the axis groups are made collectively."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs the default process group: call "
            "torch.distributed.init_process_group(backend, init_method, "
            "rank=, world_size=) first (torchrun sets the env:// variables)")
    if dist.get_backend() != backend:
        raise ValueError(f"backend={backend!r} but the default group runs "
                         f"{dist.get_backend()!r}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks; "
                         f"the world has {world}")
    index = {"data": rank // model, "model": rank % model}
    groups: Dict[str, Any] = {"data": None, "model": None}
    # new_group is collective over the whole world: every rank makes every
    # line's group in the same order, and keeps its own
    for d in range(data):
        ranks = [d * model + m for m in range(model)]
        g = dist.new_group(ranks, backend=backend) if model > 1 else None
        if d == index["data"]:
            groups["model"] = g
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        g = dist.new_group(ranks, backend=backend) if data > 1 else None
        if m == index["model"]:
            groups["data"] = g
    return Mesh(shape={"data": data, "model": model}, index=index,
                groups=groups, backend=backend)


def make_smoke_mesh(data: int = 2, model: int = 4, *,
                    backend: str = "gloo") -> Mesh:
    """The reference's small test mesh (``launch/mesh.make_smoke_mesh``),
    over the initialised world."""
    return make_mesh(data, model, backend=backend)


_MESH: contextvars.ContextVar[Optional[Any]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
# > 0 inside a TP shard body: the model-axis size of the split
_SHARD_TP: contextvars.ContextVar[int] = contextvars.ContextVar(
    "repro_torch_shard_tp", default=0)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the session mesh for the dynamic extent of the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    return _MESH.get()


@contextlib.contextmanager
def shard_tp_ctx(tp: int):
    """Mark the block as a TP shard body whose model axis has size ``tp``."""
    token = _SHARD_TP.set(int(tp))
    try:
        yield int(tp)
    finally:
        _SHARD_TP.reset(token)


def shard_tp() -> int:
    """Model-axis size of the enclosing shard body (0 outside one)."""
    return _SHARD_TP.get()


def data_axes_of(mesh) -> Tuple[str, ...]:
    """Batch-parallel axes, in mesh order ("pod" before "data")."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_size(name: str) -> int:
    """Size of a mesh axis under the current mesh (1 when absent)."""
    mesh = current_mesh()
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.shape[name]
