"""Parameter and mask trees across the package boundary, as numpy arrays.

The JAX package's trees (single-layer {"u": {"W", "R", "b"}, ..., "theta",
"out"} or stacked {"layers": [...], "out": ...}) become the port's trees of
the same structure and layout, and back.  Masks keep their None subtrees
(the dense readout)."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

Tree = Any


def _from_numpy(tree: Tree, device, dtype) -> Tree:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_from_numpy(v, device, dtype) for v in tree]
    arr = np.asarray(tree)
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=device, dtype=dtype)


def params_from_numpy(tree: Tree, device: torch.device | str,
                      dtype: torch.dtype = torch.float32) -> Tree:
    """A parameter tree of numpy arrays -> the port's tree of tensors.
    Lists (the stacked "layers" container) stay lists."""
    return _from_numpy(tree, device, dtype)


def masks_from_numpy(tree: Tree, device: torch.device | str) -> Tree:
    """A mask tree of numpy arrays (None = dense subtree) -> the port's
    float32 mask tree.  A stacked mask list stays a list."""
    return _from_numpy(tree, device, torch.float32)


def to_numpy(tree: Tree) -> Tree:
    """The port's tree -> the same structure of float32/int numpy arrays
    (bf16 leaves are widened to float32: numpy has no bfloat16)."""
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
