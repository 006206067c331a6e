"""Nested-dict parameter trees: leaves in the JAX package's order, and
maps over several trees of the same structure."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List

__all__ = ["tree_leaves", "tree_unflatten", "tree_map", "tree_unzip"]


def _fields(tree: Any) -> List[str]:
    return [f.name for f in dataclasses.fields(tree)]


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_flatten`` order: dict keys sorted at
    every level, lists and tuples in order, a dataclass (the train state)
    by its fields in declared order; ``None`` has no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in _fields(tree)
                for x in tree_leaves(getattr(tree, f))]
    return [tree]


def tree_unflatten(template: Any, leaves: Iterator[Any]) -> Any:
    """``template``'s structure with its leaves taken in order from
    ``leaves`` (the inverse of `tree_leaves`)."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: tree_unflatten(template[k], leaves)
               for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(tree_unflatten(t, leaves) for t in template)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f: tree_unflatten(getattr(template, f), leaves)
            for f in _fields(template)})
    return next(leaves)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *subtrees)`` over ``tree``'s dict structure: each of
    ``rest`` gives what sits at the leaf's path (a leaf, or a deeper
    subtree such as an optimizer's per-leaf state)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unzip(tree: Any, n: int) -> List[Any]:
    """A tree whose leaves are n-tuples → n trees."""
    return [tree_map(lambda t, i=i: t[i], tree) for i in range(n)]
