"""Checkpoints: atomic, resumable, in the JAX package's format.

One directory per step, ``step_%09d/``, with one ``leaf_%05d.npy`` per
leaf and ``meta.json``. Leaves are numbered in ``jax.tree_util.
tree_flatten`` order (`train.tree.tree_leaves`: dict keys sorted; a
`TrainState` as ``params``, ``opt_state``, ``ef``, ``step``; ``None``
has no leaf), so a checkpoint either package writes restores in the
other. Writes go to a temporary directory that is ``os.replace``d into
place, so a crash mid-save never damages the latest checkpoint, and
older steps are pruned to ``keep_last``. The arrays are whole (not
sharded): a restore may land on any device, and on any mesh. A run on a
mesh gathers each leaf whole (`train.loop.gather_state`, every rank
taking part) and rank 0 writes; a restore reads the whole tree and each
rank cuts its shards (`train.loop.shard_state`).

bf16 leaves: numpy has no bfloat16, so the port stores a bf16 leaf as
float32 (every bf16 value is one, exactly) and casts it back to the
template's bf16 on restore; the JAX package casts such a leaf to its
template's dtype the same way. A bf16 leaf the JAX package wrote (a
2-byte void array to numpy without ``ml_dtypes``) is read by its bits.
An integer leaf (the step) is stored as a 0-d int32 array.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import tree_leaves, tree_unflatten

__all__ = ["save", "restore", "latest_step", "available_steps",
           "CheckpointManager"]

_META = "meta.json"


def should_write() -> bool:
    """Only rank 0 of a process group writes (one process: always)."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:09d}")


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, tleaf: Any) -> Any:
    if not isinstance(tleaf, torch.Tensor):          # the step
        return type(tleaf)(arr.item())
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    elif arr.dtype == np.uint32:        # the reference's bitmask planes
        t = torch.from_numpy(arr.view(np.int32).copy())
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=tleaf.device, dtype=tleaf.dtype)


def _describe(state: Any) -> str:
    """The tree's structure with its leaves elided (for the meta file; a
    restore reads only the leaf count and shapes)."""
    if isinstance(state, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(state[k])}"
                               for k in sorted(state)) + "}"
    if isinstance(state, (list, tuple)):
        return "[" + ", ".join(_describe(t) for t in state) + "]"
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return type(state).__name__ + "(" + ", ".join(
            f"{f.name}={_describe(getattr(state, f.name))}"
            for f in dataclasses.fields(state)) + ")"
    return "None" if state is None else "*"


def save(root: str, step: int, state: Any,
         extra_meta: Optional[dict] = None, keep_last: int = 3) -> str:
    """Atomically persist ``state`` (a tree of tensors) at ``step``."""
    leaves = tree_leaves(state)
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f".tmp_step_{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    shapes = []
    for i, leaf in enumerate(leaves):
        arr = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        shapes.append([list(arr.shape), str(arr.dtype)])
    meta = {"step": step, "num_leaves": len(leaves), "shapes": shapes,
            "treedef": _describe(state)}
    if extra_meta:
        meta["extra"] = extra_meta
    with open(os.path.join(tmp, _META), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    final = _step_dir(root, step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _prune(root, keep_last)
    return final


def _prune(root: str, keep_last: int) -> None:
    steps = available_steps(root)
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)


def available_steps(root: str) -> List[int]:
    """Steps with a complete checkpoint (a ``meta.json``), ascending."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and os.path.exists(
                os.path.join(root, name, _META)):
            out.append(int(name[len("step_"):]))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    steps = available_steps(root)
    return steps[-1] if steps else None


def restore(root: str, template: Any, step: Optional[int] = None
            ) -> Tuple[Any, dict]:
    """(the checkpoint at ``step`` (default: the latest) in ``template``'s
    structure, each leaf on the template leaf's device in its dtype; the
    meta dict)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = _step_dir(root, step)
    with open(os.path.join(d, _META)) as f:
        meta = json.load(f)
    leaves = tree_leaves(template)
    if meta["num_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {meta['num_leaves']} leaves, template has "
            f"{len(leaves)} — config mismatch")
    out = []
    for i, tleaf in enumerate(leaves):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
        want = tuple(tleaf.shape) if isinstance(tleaf, torch.Tensor) else ()
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {i}: stored {arr.shape} != {want}")
        out.append(_from_numpy(arr, tleaf))
    return tree_unflatten(template, iter(out)), meta


@dataclasses.dataclass
class CheckpointManager:
    """Saves every ``save_every`` steps (and when forced: the run's end, an
    emergency on preemption), keeping the last ``keep_last``."""
    root: str
    save_every: int = 100
    keep_last: int = 3

    def due(self, step: int, force: bool = False) -> bool:
        """Whether `maybe_save` saves at ``step`` (on the writing rank)."""
        return force or (self.save_every > 0 and step > 0
                         and step % self.save_every == 0)

    def maybe_save(self, step: int, state: Any,
                   extra_meta: Optional[dict] = None,
                   force: bool = False) -> Optional[str]:
        if not should_write():
            return None
        if self.due(step, force):
            return save(self.root, step, state, extra_meta, self.keep_last)
        return None
