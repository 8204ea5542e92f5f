"""Minimal functional parameter-tree module system.

Counterpart of `repro.models.module`: a model is described by a tree of
:class:`ParamSpec` leaves (shape, dtype, initializer, logical axis names),
and ``materialize`` draws concrete parameters from it.  Initializers draw
from a ``torch.Generator`` on the generator's device: a seed reproduces a
model on every device of one kind, but not the JAX package's ``jax.random``
draws (parity tests transfer the reference's parameters through
``repro_torch.weights``).  The logical axis names are kept for the sharding
rules, which wait for ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map

Tree = Any


# ---------------------------------------------------------------------------
# Initializers: init(gen, shape, dtype) -> tensor on gen.device
# ---------------------------------------------------------------------------

def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def normal(stddev: float = 0.02) -> Callable:
    def init(gen, shape, dtype):
        return (stddev * _randn(gen, shape)).to(dtype)
    return init


def fan_in_normal(axis: int = -2) -> Callable:
    """LeCun-style init: stddev = 1/sqrt(fan_in). fan_in axis defaults to -2."""
    def init(gen, shape, dtype):
        fan_in = shape[axis] if len(shape) >= 2 else shape[0]
        std = 1.0 / math.sqrt(max(1, fan_in))
        return (std * _randn(gen, shape)).to(dtype)
    return init


def zeros_init() -> Callable:
    return lambda gen, shape, dtype: torch.zeros(tuple(shape), dtype=dtype,
                                                 device=gen.device)


def ones_init() -> Callable:
    return lambda gen, shape, dtype: torch.ones(tuple(shape), dtype=dtype,
                                                device=gen.device)


def constant_init(value: float) -> Callable:
    return lambda gen, shape, dtype: torch.full(tuple(shape), value,
                                                dtype=dtype, device=gen.device)


# ---------------------------------------------------------------------------
# ParamSpec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""
    shape: tuple
    dtype: Any = torch.bfloat16
    init: Callable = normal(0.02)
    axes: tuple = ()          # logical axis names, len == ndim (None = replicated)

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank != shape {self.shape} rank")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def materialize(tree: Tree, gen: torch.Generator) -> Tree:
    """Instantiate every ParamSpec, in tree order, from `gen` on its device."""
    return tree_map(lambda s: s.init(gen, s.shape, s.dtype), tree)


def stack_specs(tree: Tree, n: int, axis_name: str = "layers") -> Tree:
    """Prepend a stacking dim (the stacked-layers `units` layout)."""
    def stack(s: ParamSpec) -> ParamSpec:
        axes = (axis_name,) + (tuple(s.axes) if s.axes else (None,) * len(s.shape))

        def init(gen, shape, dtype, _inner=s.init, _n=n):
            return torch.stack([_inner(gen, shape[1:], dtype) for _ in range(_n)])
        return ParamSpec((n,) + tuple(s.shape), s.dtype, init, axes)
    return tree_map(stack, tree)


def count_params(tree: Tree) -> int:
    return sum(leaf.size if isinstance(leaf, ParamSpec) else leaf.numel()
               for leaf in tree_leaves(tree))
