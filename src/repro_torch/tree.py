"""Minimal tree utilities over the port's parameter structures: nested
dicts and lists of tensors, with None marking a subtree left alone (the
mask trees' "out": None).

`tree_flatten_with_path` and `leaf_name` walk a tree as
`jax.tree_util.tree_flatten_with_path` does (dict keys sorted, None
subtrees skipped) and name its leaves as the JAX package's checkpoint
manifest does, so a checkpoint of the port lists the same leaf names, in
the same order, as the JAX package's of the same tree."""
from __future__ import annotations

from typing import Any, Callable

import torch

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


def tree_flatten_with_path(tree: Tree, path: tuple = ()) -> list:
    """[(path, leaf)] with dict keys in sorted order and list/tuple
    indices, None subtrees contributing nothing."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def tree_map_with_path(fn: Callable, tree: Tree, path: tuple = ()) -> Tree:
    """fn(path, leaf) at every leaf, in the structure of `tree` (None
    subtrees stay None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaf_name(path: tuple) -> str:
    """Keys and indices joined by '__'; 'leaf' for a bare leaf (the JAX
    package's `checkpoint.ckpt._leaf_name`)."""
    return "__".join(str(p) for p in path) or "leaf"


def unstack(tree: Tree, n: int) -> list:
    """A tree of stacked [n, ...] tensors -> n trees of its slices along
    axis 0 (one `unbind` a leaf, whose backward stacks the n gradients in
    one op)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def stack(trees: list) -> Tree:
    """`unstack`'s inverse: n trees of one structure -> one tree of
    [n, ...] tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)
