"""Trees of tensors: nested dicts, tuples and lists, walked in JAX's order.

``jax.tree_util`` flattens a dict by its sorted keys and a tuple or list by
index, and treats ``None`` as a subtree with no leaves.  These helpers walk
the port's trees (parameters, optimizer state, gradients) the same way, so
that leaf i of a port tree is leaf i of the reference's tree of the same
structure: the checkpoint files of the two packages line up, and the
optimizer visits leaves in the reference's order.
"""

from __future__ import annotations

from typing import Any, Callable


def flatten_with_path(tree, path: tuple = ()) -> "list[tuple[tuple, Any]]":
    """(path, leaf) pairs in JAX's order; a path holds dict keys and
    sequence indices."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def path_str(path: tuple) -> str:
    """A path as the reference's checkpoint index spells it: ``a/0/wq``."""
    return "/".join(str(p) for p in path)


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with its leaves replaced, in order, by
    ``new_leaves``; raises ValueError if the counts differ."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer leaves than the tree holds") from None

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure), as ``jax.tree.map``."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
