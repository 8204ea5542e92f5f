"""Collectives over a mesh's named dims: the counted `all_reduce` /
`all_gather` every SPMD path of the port calls, and the differentiable
ones the LM's sharded steps are built from.

GSPMD has no counterpart in torch.  Where the reference leaves collectives
to XLA, the port's SPMD code runs on each rank's local shard and calls
every collective itself, through `all_reduce` and `all_gather` here, each
over named mesh dims.  The gloo backend (the CPU group, and the one-card
two-rank checks of `chip_smoke.py`) has no CUDA path for every
collective, so over a gloo group a CUDA tensor is copied to the host,
reduced or gathered there and copied back; compute stays on the card.
`counts` tallies the collectives by name.

Differentiable collectives: autograd Functions over `all_reduce` /
`all_gather`, so their backward passes are counted too.  Over 'model'
they are Megatron's pair and its gather/split pair:

  copy_to     identity forward, all_reduce backward (before a
              column-parallel product of a replicated activation)
  reduce_from all_reduce forward, identity backward (after a row-parallel
              product; the vocab-parallel sums of the loss)
  gather_from all_gather forward, the rank's slice backward
  split_to    the rank's slice forward, all_gather backward

`gather_for_use` is FSDP's weight gather over the dims the rules shard for
storage only, bucketed into one all_gather a (mesh dims, dtype); its
backward all_reduces over those of the dims the batch is split on, then
keeps the rank's slice (gloo has no reduce-scatter).  `reduce_grads` sums
the other leaves' gradients over the batch dims, one all_reduce a bucket
of at most BUCKET_BYTES.

This module knows nothing of models or rules (`sharding` re-exports it),
so `models.module.ShardCtx` calls it without an import cycle.
"""
from __future__ import annotations

import collections
import math

import torch
import torch.distributed as dist

# collectives issued through `all_reduce` / `all_gather`, by name (tests
# and chip_smoke read it around a region), and the bytes of their results
# by the same names (the reference dry-run's `collectives_raw`: result-shape
# bytes a kind)
counts: collections.Counter = collections.Counter()
counts_bytes: collections.Counter = collections.Counter()


def _count(name: str, result: torch.Tensor) -> None:
    counts[name] += 1
    counts_bytes[name] += result.numel() * result.element_size()


def _group(mesh, dims):
    """The process group of `dims` (one name, or a tuple of names in mesh
    order) of the mesh, and its size."""
    dims = (dims,) if isinstance(dims, str) else tuple(dims)
    sub = mesh[dims] if len(dims) > 1 else mesh[dims[0]]
    if len(dims) > 1:
        sub = sub._flatten()
    return sub.get_group(), sub.size()


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, mesh, dims, op: str = "sum") -> torch.Tensor:
    """Sum (or max) of `t` over the ranks of mesh dims `dims`: one
    all_reduce, into a new tensor.  On the meta device (the dry-run) it is
    counted and returns a meta result; no rank is asked."""
    group, size = _group(mesh, dims)
    if size == 1:
        return t.clone()
    if t.is_meta:
        out = torch.empty_like(t)
        _count(f"all_reduce_{op}", out)
        return out
    _count(f"all_reduce_{op}", t)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    buf = t.detach().to("cpu", copy=True) if _staged(t, group) \
        else t.detach().clone()
    dist.all_reduce(buf, op=red, group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, mesh, dims, axis: int = 0) -> torch.Tensor:
    """The ranks' `t` of mesh dims `dims` concatenated along `axis`, in
    rank order of those dims: one all_gather (on the meta device counted,
    with a meta result, and no rank asked)."""
    group, size = _group(mesh, dims)
    if size == 1:
        return t.clone()
    src = t.detach().movedim(axis, 0).contiguous()
    if _staged(t, group):
        src = src.cpu()
    out = src.new_empty((size * src.shape[0],) + tuple(src.shape[1:]))
    _count("all_gather", out)
    if not t.is_meta:
        dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device).movedim(0, axis)


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def group_index(mesh, dims) -> int:
    """This rank's index in the flattened group of mesh dims `dims` (major
    to minor), the order `all_gather` concatenates in."""
    dims = (dims,) if isinstance(dims, str) else tuple(dims)
    idx = 0
    for d in dims:
        idx = idx * mesh[d].size() + mesh.get_local_rank(d)
    return idx


def group_size(mesh, dims) -> int:
    dims = (dims,) if isinstance(dims, str) else tuple(dims)
    n = 1
    for d in dims:
        n *= mesh[d].size()
    return n


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.dims), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        return all_reduce(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, axis):
        ctx.axis, ctx.n = axis, x.shape[axis]
        ctx.lo = group_index(mesh, dims) * ctx.n
        return all_gather(x, mesh, dims, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.axis, ctx.lo, ctx.n).contiguous(), None, None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, axis):
        ctx.mesh, ctx.dims, ctx.axis = mesh, dims, axis
        n = x.shape[axis] // group_size(mesh, dims)
        return x.narrow(axis, group_index(mesh, dims) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.dims, ctx.axis), None, None, None


def copy_to(x, mesh, dims="model"):
    return _CopyTo.apply(x, mesh, dims)


def reduce_from(x, mesh, dims="model"):
    return _ReduceFrom.apply(x, mesh, dims)


def gather_from(x, mesh, axis: int, dims="model"):
    return _GatherFrom.apply(x, mesh, dims, axis % x.dim())


def split_to(x, mesh, axis: int, dims="model"):
    return _SplitTo.apply(x, mesh, dims, axis % x.dim())


class _GatherUse(torch.autograd.Function):
    """Local shards -> whole along each one's axis, over `dims`, in one
    all_gather of their flat concatenation; backward: one all_reduce over
    `red` (the dims the batch is split on, a subset of `dims`), then the
    rank's slice."""

    @staticmethod
    def forward(ctx, mesh, dims, red, axes, *xs):
        n = group_size(mesh, dims)
        ctx.mesh, ctx.dims, ctx.red, ctx.axes, ctx.n = mesh, dims, red, axes, n
        ctx.shapes = [tuple(x.shape) for x in xs]
        ctx.like = xs[0].new_zeros(())
        flat = torch.cat([x.reshape(-1) for x in xs])
        whole = all_gather(flat, mesh, dims, 0).view(n, -1)
        outs, off = [], 0
        for x, a in zip(xs, axes):
            piece = whole[:, off:off + x.numel()].reshape((n,) + tuple(x.shape))
            shape = list(x.shape)
            shape[a] *= n
            outs.append(piece.movedim(0, a).reshape(shape))
            off += x.numel()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n, parts = ctx.n, []
        for g, shape, a in zip(gs, ctx.shapes, ctx.axes):
            split = shape[:a] + (n,) + shape[a:]
            if g is None:
                parts.append(ctx.like.new_zeros((n, math.prod(shape))))
                continue
            parts.append(g.reshape(split).movedim(a, 0).reshape(n, -1))
        flat = torch.cat(parts, 1).reshape(-1)
        if ctx.red:
            flat = all_reduce(flat, ctx.mesh, ctx.red)
        mine = flat.view(n, -1)[group_index(ctx.mesh, ctx.dims)]
        grads, off = [], 0
        for shape in ctx.shapes:
            k = math.prod(shape)
            grads.append(mine[off:off + k].reshape(shape))
            off += k
        return (None, None, None, None) + tuple(grads)


def _by_key(items, key):
    groups: dict = {}
    for i, item in enumerate(items):
        groups.setdefault(key(item), []).append(i)
    return groups


def gather_for_use(leaves: list, plans: list, mesh, batch: tuple) -> list:
    """Each leaf gathered whole along every (tensor dim, mesh dims) of its
    plan, stage by stage: stage k takes the k-th entry of every plan that
    has one, one `_GatherUse` a (mesh dims, dtype) bucket.  The backward
    sums over the mesh dims in `batch`."""
    out = list(leaves)
    depth = max((len(p) for p in plans), default=0)
    for k in range(depth):
        todo = [i for i, p in enumerate(plans) if len(p) > k]
        groups = _by_key(todo, lambda i: (plans[i][k][1], out[i].dtype))
        for (dims, _), pos in groups.items():
            idx = [todo[j] for j in pos]
            red = tuple(d for d in dims if d in batch)
            res = _GatherUse.apply(mesh, dims, red,
                                   tuple(plans[i][k][0] for i in idx),
                                   *(out[i] for i in idx))
            for i, r in zip(idx, res):
                out[i] = r
    return out


# a gradient bucket's bytes at most (one leaf larger than it is a bucket
# of its own): the flat copy and the reduced one are transient beside the
# gradients, so the cap bounds what the reduction adds to a step's peak
BUCKET_BYTES = 256 << 20


def _buckets(idx: list, nbytes) -> list:
    """Consecutive runs of `idx` of at most BUCKET_BYTES each."""
    out, cur, size = [], [], 0
    for i in idx:
        if cur and size + nbytes(i) > BUCKET_BYTES:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes(i)
    return out + ([cur] if cur else [])


def reduce_grads(grads: list, dims: list, mesh) -> list:
    """Each gradient summed over its mesh dims (a tuple, () for none), in
    place: one all_reduce a bucket of flat concatenations, a bucket holding
    leaves of one (dims, dtype) up to BUCKET_BYTES, whose sums are copied
    back into the gradients (no second copy of them outlives the bucket)."""
    out = list(grads)
    groups = _by_key(range(len(grads)), lambda i: (dims[i], grads[i].dtype))
    size = lambda i: grads[i].numel() * grads[i].element_size()
    for (ds, _), idx in groups.items():
        if not ds:
            continue
        for bucket in _buckets(idx, size):
            parts = [grads[i].reshape(-1) for i in bucket]
            flat = all_reduce(parts[0] if len(parts) == 1 else torch.cat(parts),
                              mesh, ds)
            off = 0
            for i in bucket:
                k = grads[i].numel()
                out[i] = grads[i].copy_(flat[off:off + k].view(grads[i].shape))
                off += k
    return out
