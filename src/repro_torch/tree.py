"""Nested-dict trees of tensors in ``jax.tree_util``'s order.

The training state (params, optimizer moments, checkpoints) is a tree of
plain dicts whose leaves are tensors. These helpers visit the leaves in
the order ``jax.tree_util.tree_flatten`` gives a dict tree: keys sorted,
depth first. Checkpoint files list their leaves in that order, so a
checkpoint written by either framework restores into the other.
"""
from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["leaves", "unflatten", "tree_map", "treedef_str"]


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` (dict keys sorted, depth first)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(example: Any, flat: List[Any]) -> Any:
    """A tree shaped like ``example`` whose leaves are ``flat`` in order."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(example)
    if next(it, None) is not None:
        raise ValueError("more leaves than the example tree holds")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def treedef_str(tree: Any) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))`` writes
    it, e.g. ``PyTreeDef({'a': *, 'b': {'c': *}})`` (a description only:
    no reader parses it back)."""
    def render(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {render(node[k])}"
                                   for k in sorted(node)) + "}"
        return "*"

    return f"PyTreeDef({render(tree)})"

