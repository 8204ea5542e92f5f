"""Parameter and mask trees across the package boundary, as numpy arrays.

The JAX package's trees become the port's trees of the same structure and
layout, and back: the EGRU trees (single-layer {"u": {"W", "R", "b"}, ...,
"theta", "out"} or stacked {"layers": [...], "out": ...}) and the model
trees of `repro.models` (nested dicts, the stacked `units` arrays or the
`units` list, float32 and bfloat16 leaves).  Masks keep their None subtrees
(the dense readout)."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

Tree = Any


def _leaf_dtype(arr: np.ndarray) -> torch.dtype:
    """bfloat16 numpy arrays (ml_dtypes, as the JAX package hands them
    out) stay bfloat16; everything else becomes float32."""
    return torch.bfloat16 if arr.dtype.name == "bfloat16" else torch.float32


def _from_numpy(tree: Tree, device, dtype) -> Tree:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_from_numpy(v, device, dtype) for v in tree]
    arr = np.asarray(tree)
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=device, dtype=_leaf_dtype(arr) if dtype is None else dtype)


def params_from_numpy(tree: Tree, device: torch.device | str,
                      dtype: torch.dtype | None = torch.float32) -> Tree:
    """A parameter tree of numpy arrays -> the port's tree of tensors, all
    of `dtype`, or with dtype=None each leaf's own (bfloat16 stays
    bfloat16, every other leaf float32).  Lists (the stacked "layers"
    container, the unstacked "units") stay lists."""
    return _from_numpy(tree, device, dtype)


def masks_from_numpy(tree: Tree, device: torch.device | str) -> Tree:
    """A mask tree of numpy arrays (None = dense subtree) -> the port's
    float32 mask tree.  A stacked mask list stays a list."""
    return _from_numpy(tree, device, torch.float32)


def to_numpy(tree: Tree) -> Tree:
    """The port's tree -> the same structure of float32/int numpy arrays
    (bf16 leaves are widened to float32, which is exact: numpy has no
    bfloat16)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
