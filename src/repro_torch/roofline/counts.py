"""Per-step flops, bytes and collective bytes of one rank: the port's
counterpart of the reference's HLO analyzer (`repro.roofline.hlo`).

The reference lowers a jitted step and reads the three roofline inputs out
of XLA's per-device HLO text. The port has no HLO: its step is eager
PyTorch on one rank's local tensors, with explicit collectives. So
`count_step` runs the step itself, on any device (the ``meta`` device
for a dry run, whose tensors carry shapes and no values), and counts as
it goes:

  * flops / hbm_bytes of the dispatcher's front doors
    (`kernels.dispatch`: matmul, conv, attention, attn_decode,
    head_sample) — each call adds the cost of the route `select` chose,
    the dispatcher's own roofline terms (so a packed leaf on a kernel
    route counts its compressed planes, not a dense ``[K, N]``). The
    count reads the config and the op's `OpSpec` only, never the device;
    aten ops inside a front door are not counted again (on the card the
    kernel's launch is invisible here anyway);
  * flops / hbm_bytes of every other aten op, through a
    `TorchDispatchMode`: operand + output bytes as the reference counts a
    top-level HLO op (views, which move nothing, are free like its
    bitcasts), and ``2·M·K·N`` flops for ``mm`` / ``addmm`` / ``bmm`` /
    ``baddbmm`` and the convolutions — the norms, RoPE, the embedding,
    cache writes, the MoE and recurrent layers' expanded ``x @ w``, a
    train step's backward;
  * collective_bytes / collective_counts by LOGICAL kind, from
    `dist.collectives` (`collective`): an all-gather that runs as the
    all-reduce of a zero-filled buffer (gloo) counts as an
    ``all-gather`` of its operand, so `roofline.analysis.collective_bw`
    models it as the reference models an HLO all-gather. Payload bytes
    are the operand's, as the reference counts them.

The port's layer loop is eager, so every layer is counted as it runs: no
trip counts are needed. The reference's ``cpu_upcast_param_bytes`` (f32
copies of bf16 weights that XLA:CPU hoists) has no counterpart: no
compile here makes them.

The mode also tracks the rank's peak live bytes: every storage an op
creates during the step (on ``peak_device``'s type, or on any device),
freed by a weakref finalizer when its last tensor goes. It stands in for
the reference's ``memory_analysis().temp_size_in_bytes`` (the step's
inputs are not in it; the caller adds them). On the card it is held
against the caching allocator's peak (`chip_smoke.py`, the dryrun
phase); ``peak_device="cuda"`` leaves out host tensors such as a packed
prefill's scatter addresses.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

__all__ = ["StepStats", "StepCounter", "count_step", "route_call",
           "collective"]

_aten = torch.ops.aten

# ops that allocate and move nothing a kernel reads or writes
_FREE_OPS = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten._local_scalar_dense.default,
}


@dataclasses.dataclass
class StepStats:
    """One rank's step: the reference's `HloStats` fields (``flops``,
    ``hbm_bytes``, ``collective_bytes`` / ``collective_counts`` by kind,
    ``top_ops``: (kind, bytes, trips, name) of each collective) and the
    port's breakdown: ``routes`` (dispatcher route → [calls, flops,
    bytes]), ``ops`` (aten op outside the dispatcher → [calls, flops,
    bytes]) and ``peak_bytes`` (the most bytes the step held live beyond
    its inputs)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    top_ops: List[Tuple[str, float, float, str]] = dataclasses.field(
        default_factory=list)
    routes: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    ops: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def top_collectives(self, k: int = 12) -> List[Tuple[str, float, str]]:
        """[(kind, total bytes, name)] sorted by traffic."""
        rows = [(kind, b * t, name) for kind, b, t, name in self.top_ops]
        rows.sort(key=lambda r: -r[1])
        return rows[:k]

    def top_aten(self, k: int = 12) -> List[Tuple[str, float, float, float]]:
        """[(aten op, calls, flops, bytes)] sorted by bytes."""
        rows = [(name, *v) for name, v in self.ops.items()]
        rows.sort(key=lambda r: -r[3])
        return rows[:k]


def _add(table: Dict[str, List[float]], key: str, flops: float,
         nbytes: float) -> None:
    row = table.setdefault(key, [0, 0.0, 0.0])
    row[0] += 1
    row[1] += flops
    row[2] += nbytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of an aten op's arguments or results (tensors, lists
    and tuples of them, scalars), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _mm_flops(func, args, out) -> float:
    """2·M·K·N of the matrix products (batched: times the batch); a
    convolution's 2 · output elements · its kernel window (C_in/groups ·
    kh · kw; transposed: 2 · input elements · the window)."""
    if func in (_aten.mm.default, _aten.bmm.default):
        a, b = args[0], args[1]
    elif func in (_aten.addmm.default, _aten.baddbmm.default):
        a, b = args[1], args[2]
    elif func is _aten.convolution.default:
        x, w, transposed = args[0], args[1], args[6]
        window = w.numel() // max(w.shape[0], 1)
        return 2.0 * (x.numel() if transposed else out.numel()) * window
    else:
        return 0.0
    return 2.0 * a.numel() * b.shape[-1]


def _is_view(func) -> bool:
    """Whether every return of ``func`` aliases an input that no argument
    writes: a view or a metadata op, which moves no bytes."""
    schema = func._schema
    if not schema.returns or any(r.alias_info is None
                                 for r in schema.returns):
        return False
    return not any(a.alias_info is not None and a.alias_info.is_write
                   for a in schema.arguments)


class StepCounter(TorchDispatchMode):
    """The counting mode; `count_step` runs a step under one and returns
    its `StepStats`. Dispatcher front doors enter `route_call` and
    `dist.collectives` calls `collective`, each of which finds the live
    counter on the dispatch-mode stack (which autograd's backward carries
    too) and does nothing without one."""

    def __init__(self, peak_device: Optional[str] = None):
        super().__init__()
        self.stats = StepStats()
        self._peak_device = peak_device
        self._route_depth = 0
        self._live = 0
        self._tracked: Dict[int, int] = {}

    # -- peak live bytes ---------------------------------------------------

    def _free(self, key: int) -> None:
        self._live -= self._tracked.pop(key, 0)

    def _track(self, args, outs) -> None:
        seen = {id(t.untyped_storage()) for t in args}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._tracked or (
                    self._peak_device is not None
                    and t.device.type != self._peak_device):
                continue
            seen.add(key)
            size = st.nbytes()
            self._tracked[key] = size
            self._live += size
            weakref.finalize(st, self._free, key)
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._live)

    # -- aten ops ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat_in = _tensors((args, kwargs), [])
        flat_out = _tensors(out, [])
        self._track(flat_in, flat_out)
        if (self._route_depth or func.namespace == "c10d"
                or func in _FREE_OPS or _is_view(func)):
            return out
        nbytes = sum(_nbytes(t) for t in flat_in + flat_out)
        flops = _mm_flops(func, args, out)
        self.stats.flops += flops
        self.stats.hbm_bytes += nbytes
        _add(self.stats.ops, str(func.overloadpacket.__name__), flops,
             nbytes)
        return out

    # -- hooks ---------------------------------------------------------------

    def add_route(self, route: str, flops: float, nbytes: float) -> None:
        self.stats.flops += flops
        self.stats.hbm_bytes += nbytes
        _add(self.stats.routes, route, flops, nbytes)

    def add_collective(self, kind: str, nbytes: float, name: str) -> None:
        st = self.stats
        st.collective_bytes[kind] = st.collective_bytes.get(kind, 0.0) + nbytes
        st.collective_counts[kind] = st.collective_counts.get(kind, 0.0) + 1
        st.top_ops.append((kind, float(nbytes), 1.0, name))


def _active() -> Optional[StepCounter]:
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, StepCounter):
            return mode
    return None


@contextlib.contextmanager
def route_call(route: str, cost: Callable[[], Tuple[float, float]]):
    """The extent of one dispatcher front-door call that runs ``route``:
    the live counter adds its ``cost()`` (flops, bytes; asked only under a
    counter, so serving pays nothing for it) and counts no aten op inside
    (a front door nested in another counts nothing)."""
    c = _active()
    if c is None or c._route_depth:
        yield
        return
    c.add_route(route, *cost())
    c._route_depth += 1
    try:
        yield
    finally:
        c._route_depth -= 1


def collective(kind: str, x: torch.Tensor, name: str = "") -> None:
    """Count one collective of logical ``kind`` whose operand is ``x``
    (nothing without a live counter)."""
    c = _active()
    if c is not None:
        c.add_collective(kind, float(_nbytes(x)),
                         f"{name or kind}:{list(x.shape)} {x.dtype}")


def count_step(fn: Callable, *args, peak_device: Optional[str] = None,
               **kwargs) -> Tuple[Any, StepStats]:
    """(``fn(*args, **kwargs)``, the `StepStats` of that call); the peak
    counts storages on ``peak_device``'s type (None: every device)."""
    with StepCounter(peak_device) as counter:
        out = fn(*args, **kwargs)
    return out, counter.stats
