"""Nested-dict trees: the port's parameter, optimizer and train states.

A tree is a dict whose values are trees or leaves (tensors, numpy
arrays, anything that is not a dict).  Leaves come in sorted key order
at every level — ``jax.tree``'s order for dicts — and a leaf's path is
its keys joined by ``/`` (``params/blocks/wq``), the reference's
checkpoint key.
"""

from __future__ import annotations

from typing import Any, Callable


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in sorted key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: list[tuple[str, Any]] = []
    for key in sorted(tree):
        out += flatten(tree[key], f"{prefix}/{key}" if prefix else str(key))
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(template: Any, new_leaves) -> Any:
    """``template``'s structure with ``new_leaves`` in flatten order."""
    return _build(template, iter(new_leaves))


def _build(node: Any, it) -> Any:
    # a module-level function, not a recursive closure: a closure that
    # refers to itself is a reference cycle, which would keep the leaves
    # (a training step's gradients) alive until the cyclic collector ran
    if not isinstance(node, dict):
        return next(it)
    return {key: _build(node[key], it) for key in sorted(node)}


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``, trees of the same structure)."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
            for key in sorted(tree)}
