"""Minimal functional parameter-tree module system.

Counterpart of `repro.models.module`: a model is described by a tree of
:class:`ParamSpec` leaves (shape, dtype, initializer, logical axis names),
and ``materialize`` draws concrete parameters from it.  Initializers draw
from a ``torch.Generator`` on the generator's device: a seed reproduces a
model on every device of one kind, but not the JAX package's ``jax.random``
draws (parity tests transfer the reference's parameters through
``repro_torch.weights``).

The logical axis names map to mesh dims through ``ShardingRules``
(``pspec_for``, the reference's divisibility fallback).  A PartitionSpec
is a tuple of the reference's form (each entry None, a mesh dim name or a
tuple of names, trailing Nones trimmed), and a NamedSharding
(`NamedSharding`) is a torch ``DeviceMesh`` with that tuple, whose
``placements`` are DTensor's: one ``Shard(d)`` or ``Replicate()`` a mesh
dim.  The rule functions read the mesh's ``{name: size}`` only
(`mesh_shape`), so they run on a plain dict as on a DeviceMesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch import collectives as C
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
        return _randn(gen, shape).mul_(stddev).to(dtype)
    return init


def fan_in_normal(axis: int = -2) -> Callable:
    """LeCun-style init: stddev = 1/sqrt(fan_in). fan_in axis defaults to -2."""
    def init(gen, shape, dtype):
        fan_in = shape[axis] if len(shape) >= 2 else shape[0]
        std = 1.0 / math.sqrt(max(1, fan_in))
        return _randn(gen, shape).mul_(std).to(dtype)
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


def uniform_init(lo: float, hi: float) -> Callable:
    """U[lo, hi) drawn in float32, then cast."""
    def init(gen, shape, dtype):
        u = torch.rand(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)
        return (lo + (hi - lo) * u).to(dtype)
    return init


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
    """Instantiate every ParamSpec, in tree order, from `gen` on its device.
    A leaf's transient memory is its float32 draw and its cast (scaled in
    place), and a stacked leaf is filled slice by slice: a full-size
    model draws on one card beside the leaves already drawn."""
    return tree_map(lambda s: s.init(gen, s.shape, s.dtype), tree)


def abstract(tree: Tree) -> Tree:
    """Stand-ins for the dry-run: a `meta` tensor of each spec's shape and
    dtype (no storage is allocated, nothing is drawn)."""
    return tree_map(lambda s: torch.empty(tuple(s.shape), dtype=s.dtype,
                                          device="meta"), tree)


def stack_specs(tree: Tree, n: int, axis_name: str = "layers") -> Tree:
    """Prepend a stacking dim (the stacked-layers `units` layout)."""
    def stack(s: ParamSpec) -> ParamSpec:
        axes = (axis_name,) + (tuple(s.axes) if s.axes else (None,) * len(s.shape))

        def init(gen, shape, dtype, _inner=s.init, _n=n):
            out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
            for i in range(_n):
                out[i] = _inner(gen, shape[1:], dtype)
            return out
        return ParamSpec((n,) + tuple(s.shape), s.dtype, init, axes)
    return tree_map(stack, tree)


def count_params(tree: Tree) -> int:
    return sum(leaf.size if isinstance(leaf, ParamSpec) else leaf.numel()
               for leaf in tree_leaves(tree))


# ---------------------------------------------------------------------------
# Logical axis rules -> shardings
# ---------------------------------------------------------------------------

def mesh_shape(mesh) -> dict:
    """{dim name: size} of a torch DeviceMesh, or of a plain mapping (the
    rule functions' abstract mesh: no ranks needed), in mesh-dim order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to mesh axis names (or tuples thereof)."""
    rules: Mapping[str, Any]

    def mesh_axes(self, logical: str | None):
        if logical is None:
            return None
        return self.rules.get(logical, None)


def _axis_size(mesh, mesh_axes) -> int:
    if mesh_axes is None:
        return 1
    if isinstance(mesh_axes, str):
        mesh_axes = (mesh_axes,)
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in mesh_axes)


def pspec_for(spec_axes: Sequence, shape: Sequence[int], rules: ShardingRules,
              mesh) -> tuple:
    """PartitionSpec tuple with the divisibility fallback.

    A dim not divisible by the product of its assigned mesh axes sheds
    trailing axes until it is (replicated when none is left): this lets
    one rule-set serve archs with e.g. 8 query heads on a 16-way model
    axis.  A mesh axis is used at most once a tensor.  Trailing None
    entries are trimmed, as `PartitionSpec` prints them."""
    sizes = mesh_shape(mesh)
    used: set = set()
    entries = []
    axes = tuple(spec_axes) if spec_axes else (None,) * len(shape)
    for dim, logical in zip(shape, axes):
        mesh_axes = rules.mesh_axes(logical)
        if mesh_axes is None:
            entries.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        # drop axes already used by another dim of this tensor
        mesh_axes = tuple(a for a in mesh_axes if a not in used and a in sizes)
        while mesh_axes and dim % _axis_size(sizes, mesh_axes) != 0:
            mesh_axes = mesh_axes[:-1]     # shed trailing axes until divisible
        if not mesh_axes:
            entries.append(None)
        else:
            used.update(mesh_axes)
            entries.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements_for(spec: Sequence, dim_names: Sequence[str]) -> tuple:
    """DTensor placements of a PartitionSpec tuple on a mesh with these dim
    names: ``Shard(d)`` on every mesh dim that tensor dim d names,
    ``Replicate()`` elsewhere.  Several mesh dims on one tensor dim split
    it major to minor in the entry's order, which DTensor's left-to-right
    mesh-dim order expresses only when the entry lists them in mesh order
    (the reference's rules always do: ('pod', 'data'))."""
    from torch.distributed.tensor import Replicate, Shard
    out: list = [Replicate()] * len(dim_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [dim_names.index(a) for a in names]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} is not in mesh-dim order "
                             f"{tuple(dim_names)}")
        for i in pos:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh (a torch DeviceMesh, or its {name: size} for the rule
    functions) and a PartitionSpec tuple: the reference's NamedSharding."""
    mesh: Any
    spec: tuple = ()

    def __post_init__(self):
        # as PartitionSpec does: a one-name tuple entry is that name
        object.__setattr__(self, "spec", tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in self.spec))

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, tuple(mesh_shape(self.mesh)))


def tree_shardings(tree: Tree, rules: ShardingRules, mesh) -> Tree:
    """NamedSharding tree matching a ParamSpec tree."""
    return tree_map(
        lambda s: NamedSharding(mesh, pspec_for(s.axes, s.shape, rules, mesh)),
        tree)


def tree_pspecs(tree: Tree, rules: ShardingRules, mesh) -> Tree:
    return tree_map(lambda s: pspec_for(s.axes, s.shape, rules, mesh), tree)


def logical_constraint(x: torch.Tensor, axes: Sequence, rules: ShardingRules,
                       mesh) -> torch.Tensor:
    """The reference's with_sharding_constraint by logical axes: nothing
    without a mesh; a DTensor is redistributed to the rules' placements
    (DTensor issues the collectives that takes); a plain tensor is a
    rank's local value in SPMD code and stays as it is."""
    from torch.distributed.tensor import DTensor
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = pspec_for(axes, x.shape, rules, mesh)
    return x.redistribute(mesh, placements_for(spec, mesh.mesh_dim_names))


# A context-free handle passed down the model call stack.
@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The mesh and rules a model call runs under.  With a mesh the call
    is explicit SPMD on this rank's local tensors: `use` gathers a
    parameter subtree over the dims the rules shard for storage only (FSDP:
    what is left is the rank's slice on 'model'), the layers read a
    weight's 'model' split off its local shape, and the collectives below
    (`collectives`' differentiable ones) run over 'model' or over `batch`,
    the mesh dims this call's batch rows are split on.  Every method is
    the identity without a mesh (`NULL_CTX`)."""
    mesh: Any
    rules: ShardingRules
    batch: tuple = ()
    seq: int = 0          # serving: the whole length of the decode cache

    def cons(self, x: torch.Tensor, axes: Sequence) -> torch.Tensor:
        return logical_constraint(x, axes, self.rules, self.mesh)

    @property
    def on(self) -> bool:
        return self.mesh is not None

    def model_lo(self, n_local: int) -> int:
        """First index of this rank's slice of a dim split over 'model' in
        slices of n_local."""
        return self.mesh.get_local_rank("model") * n_local

    def model_split(self, logical: str, size: int) -> bool:
        """Whether the rules put 'model' on a dim `logical` of `size`."""
        if not self.on:
            return False
        return pspec_for((logical,), (size,), self.rules, self.mesh) \
            in (("model",),)

    def copy(self, x):
        return C.copy_to(x, self.mesh) if self.on else x

    def reduce(self, x):
        return C.reduce_from(x, self.mesh) if self.on else x

    def gather(self, x, axis: int):
        return C.gather_from(x, self.mesh, axis) if self.on else x

    def split(self, x, axis: int):
        return C.split_to(x, self.mesh, axis) if self.on else x

    def keep(self, x, axis: int, n_local: int):
        """This rank's slice (n_local wide) of a replicated x on a dim the
        rules split over 'model'; no gradient flows (serving state)."""
        if not self.on or x.shape[axis] == n_local:
            return x
        return x.narrow(axis, self.model_lo(n_local), n_local).contiguous()

    def model_max(self, x):
        """The max over 'model' (no gradient)."""
        return C.all_reduce(x.detach(), self.mesh, "model", "max") \
            if self.on else x

    def reduce_batch(self, x):
        """The sum over the batch's split dims: all_reduce forward, identity
        backward (each rank differentiates its own rows' share)."""
        return C.reduce_from(x, self.mesh, self.batch) \
            if self.on and self.batch else x

    def use(self, params: Tree, specs: Tree) -> Tree:
        """The weights for use: every leaf gathered over the mesh dims its
        spec puts on it other than 'model' (one all_gather a bucket)."""
        if not self.on:
            return params
        leaves, plans = [], []

        sizes = mesh_shape(self.mesh)

        def plan(x, s):
            spec = pspec_for(s.axes, s.shape, self.rules, self.mesh)
            dims = [(d, (e,) if isinstance(e, str) else tuple(e))
                    for d, e in enumerate(spec) if e is not None]
            leaves.append(x)
            plans.append([(d, names) for d, names in dims
                          if "model" not in names
                          and math.prod(sizes[n] for n in names) > 1])
            return len(leaves) - 1

        idx = tree_map(plan, params, specs)
        out = C.gather_for_use(leaves, plans, self.mesh, self.batch)
        return tree_map(lambda i: out[i], idx)

    def use_top(self, params: dict, specs_fn: Callable,
                layers: tuple = ("units",)) -> dict:
        """A model's params with every top-level leaf but the `layers`
        subtrees' for use (`use`; specs_fn() gives the model's spec tree);
        those are gathered a unit or a layer at a time as they run."""
        if not self.on:
            return params
        specs = specs_fn()
        top = {k: v for k, v in params.items() if k not in layers}
        return {**self.use(top, {k: specs[k] for k in top}),
                **{k: params[k] for k in layers}}


NULL_CTX = ShardCtx(None, ShardingRules({}))
