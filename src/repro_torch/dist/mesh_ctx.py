"""Session-wide mesh context over `torch.distributed` process groups.

The reference keeps a live ``jax.sharding.Mesh`` in a contextvar that
model code reads at trace time. Here every rank is one process holding
its shard as plain local tensors, and a `Mesh` is the rank's view of the
device grid: the axis names (``("data", "model")``, or ``("pod", "data",
"model")`` with the reference's outer pod axis), each axis's size, this
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

``use_train_layout(layout)`` marks the extent of a training step on a
mesh (`train.loop`): a `TrainLayout` says which weights arrive split over
the model axis (so the model's mesh branches run Megatron's column / row
blocks on them), over which axes the batch is split, and whether the
residual stream is sequence-parallel. It is the port's form of what the
reference's GSPMD graph reads off its sharded arrays.

`shard_hint` is the reference's ``shard_hint`` made concrete: where the
reference asks GSPMD to lay a global array out along mesh axes, this cuts
the rank's block out of it (a global batch, or a residual stream).
``repro.dist.compat`` is a shim for jax's ``shard_map`` spelling and has no
counterpart.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional, Tuple

__all__ = ["Mesh", "make_mesh", "make_smoke_mesh", "use_mesh",
           "current_mesh", "data_axes_of", "axis_size", "shard_tp_ctx",
           "shard_tp", "shard_hint", "TrainLayout", "use_train_layout",
           "train_layout"]

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a ``[pod ×] data × model`` grid of ranks:
    ``shape`` maps each axis to its size, ``index`` to this rank's
    coordinate, ``groups`` to the process group of the ranks on this
    rank's line along the axis (None where the axis has size 1: no
    collective runs over it). Ranks are laid out row-major over
    ``axis_names``, the model axis the fastest, as in the reference's
    ``jax.make_mesh``."""
    shape: Dict[str, int]
    index: Dict[str, int]
    groups: Dict[str, Any]
    backend: str
    axis_names: Tuple[str, ...] = AXES


def make_mesh(data: int, model: int, *, backend: str,
              pod: Optional[int] = None) -> Mesh:
    """The mesh of ``[pod ×] data × model`` ranks over the initialised
    default group (its world size must be the product). ``pod`` adds the
    reference's outermost "pod" axis (``launch/mesh.py``). Every rank calls
    it with the same arguments: the axis groups are made collectively."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs the default process group: call "
            "torch.distributed.init_process_group(backend, init_method, "
            "rank=, world_size=) first (torchrun sets the env:// variables)")
    if dist.get_backend() != backend:
        raise ValueError(f"backend={backend!r} but the default group runs "
                         f"{dist.get_backend()!r}")
    names = POD_AXES if pod else AXES
    sizes = (pod, data, model) if pod else (data, model)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = 1
    for s in sizes:
        n *= s
    if n != world:
        raise ValueError(f"mesh {'x'.join(map(str, sizes))} needs {n} "
                         f"ranks; the world has {world}")
    strides = [1] * len(sizes)
    for i in reversed(range(len(sizes) - 1)):
        strides[i] = strides[i + 1] * sizes[i + 1]
    coords = [(rank // strides[i]) % sizes[i] for i in range(len(sizes))]
    groups: Dict[str, Any] = {}
    # new_group is collective over the whole world: every rank makes every
    # line's group in the same order, and keeps its own
    for a, name in enumerate(names):
        groups[name] = None
        if sizes[a] == 1:
            continue
        for r0 in range(world):
            if (r0 // strides[a]) % sizes[a]:
                continue                     # not the first rank of a line
            ranks = [r0 + i * strides[a] for i in range(sizes[a])]
            g = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                groups[name] = g
    return Mesh(shape=dict(zip(names, sizes)),
                index=dict(zip(names, coords)), groups=groups,
                backend=backend, axis_names=names)


def make_smoke_mesh(data: int = 2, model: int = 4, *, backend: str = "gloo",
                    pod: Optional[int] = None) -> Mesh:
    """The reference's small test mesh (``launch/mesh.make_smoke_mesh``),
    over the initialised world."""
    return make_mesh(data, model, backend=backend, pod=pod)


_MESH: contextvars.ContextVar[Optional[Any]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
# > 0 inside a TP shard body: the model-axis size of the split
_SHARD_TP: contextvars.ContextVar[int] = contextvars.ContextVar(
    "repro_torch_shard_tp", default=0)
_LAYOUT: contextvars.ContextVar[Optional["TrainLayout"]] = \
    contextvars.ContextVar("repro_torch_train_layout", default=None)


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


def shard_hint(x, *entries):
    """This rank's block of the global ``x``: one entry per leading dim (an
    axis name, a tuple of names, or None; missing entries None), the first
    name of a tuple the major one, as a NamedSharding lays it out. Axes
    absent from the live mesh are dropped, and a dim that does not divide
    its axes' product stays whole, as the reference's hint falls back to
    replication. ``x`` itself without a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return x
    for dim, e in enumerate(entries[:x.ndim]):
        axes = tuple(a for a in ((e,) if isinstance(e, str) else (e or ()))
                     if a in mesh.axis_names)
        n, idx = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + mesh.index[a]
        if n > 1 and x.shape[dim] % n == 0:
            size = x.shape[dim] // n
            x = x.narrow(dim, idx * size, size)
    return x


@dataclasses.dataclass(frozen=True)
class TrainLayout:
    """How a training step's tensors lie on the live mesh.

    ``tp``: the model axis's size. ``split``: the weight kinds that arrive
    as this rank's model-axis slice — "vocab" (the embedding's rows),
    "head" (the LM head's columns), "attn" (Q heads and KV columns, o_proj
    rows), "mlp" (wi / wg columns, wo rows), "experts" (whole experts);
    every other weight arrives whole. ``batch_axes``: the axes the batch
    rows are split over (a loss mean sums over them). ``sp``: the residual
    stream is split along the sequence over the model axis (Megatron's
    sequence parallelism; set by the model's forward)."""
    tp: int = 1
    split: frozenset = frozenset()
    batch_axes: Tuple[str, ...] = ()
    sp: bool = False


@contextlib.contextmanager
def use_train_layout(layout: Optional[TrainLayout]):
    """Make ``layout`` the training layout for the dynamic extent of the
    block."""
    token = _LAYOUT.set(layout)
    try:
        yield layout
    finally:
        _LAYOUT.reset(token)


def train_layout() -> Optional[TrainLayout]:
    """The live training layout (None outside a training step on a
    mesh)."""
    return _LAYOUT.get()
