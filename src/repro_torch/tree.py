"""Minimal tree utilities over the port's parameter structures: nested
dicts and lists of tensors, with None marking a subtree left alone (the
mask trees' "out": None)."""
from __future__ import annotations

from typing import Any, Callable

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply fn leaf-wise over trees of the same structure as `tree`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """Leaves in insertion order (None subtrees contribute nothing)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def apply_mask_tree(mask: Tree, tree: Tree) -> Tree:
    """Mask-first walk: a None mask leaves its whole subtree untouched."""
    if mask is None:
        return tree
    if isinstance(mask, dict):
        out = dict(tree)
        out.update({k: apply_mask_tree(m, tree[k]) for k, m in mask.items()})
        return out
    if isinstance(mask, (list, tuple)):
        return type(mask)(apply_mask_tree(m, t) for m, t in zip(mask, tree))
    return tree * mask.to(tree.dtype)
