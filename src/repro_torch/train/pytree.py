"""The few tree operations the training slice needs, in JAX's leaf order.

A tree is a nest of dicts (walked in sorted key order), lists and tuples
(in order) and :class:`~repro_torch.train.optimizer.AdamWState` (its
fields ``step``, ``m``, ``v``); ``None`` holds no leaf and anything else is
a leaf. That is the order in which ``jax.tree.flatten`` walks the same
structure, so a tree laid out as the reference's gives the reference's
leaves one by one (what makes checkpoint files cross the packages).
"""
from __future__ import annotations

import dataclasses

__all__ = ["tree_flatten", "tree_leaves", "tree_map", "tree_unflatten"]


def _children(tree):
    """``(children, rebuild)`` of a container node, or None for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda vals: dict(zip(keys, vals))
    if isinstance(tree, (list, tuple)):
        return list(tree), (list if isinstance(tree, list) else tuple)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return [getattr(tree, n) for n in names], \
            lambda vals, cls=type(tree): cls(**dict(zip(names, vals)))
    return None


def tree_flatten(tree) -> tuple[list, object]:
    """``(leaves, treedef)``: the leaves in JAX's order and what
    :func:`tree_unflatten` needs to rebuild the structure."""
    if tree is None:
        return [], None
    node = _children(tree)
    if node is None:
        return [tree], "*"
    children, rebuild = node
    leaves, defs = [], []
    for child in children:
        sub, d = tree_flatten(child)
        leaves.extend(sub)
        defs.append((len(sub), d))
    return leaves, (rebuild, defs)


def tree_unflatten(treedef, leaves: list):
    """The structure of ``treedef`` with ``leaves`` in order."""
    if treedef is None:
        return None
    if treedef == "*":
        (leaf,) = leaves
        return leaf
    rebuild, defs = treedef
    out, i = [], 0
    for n, d in defs:
        out.append(tree_unflatten(d, leaves[i:i + n]))
        i += n
    return rebuild(out)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(t) for t in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"trees differ: {len(leaves)} leaves against {len(o)}")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
