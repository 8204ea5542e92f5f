"""Logical-axis sharding rules: DP / FSDP(ZeRO-3) / TP / EP / SP, the
placement of host arrays on a mesh, and the collectives the port calls
over a mesh's named dims.

Counterpart of `repro.sharding`.  One rule-set serves every architecture
because ``pspec_for`` drops non-divisible assignments per tensor (e.g.
gemma2's 8 query heads on a 16-way model axis fall back to replicated
heads while its d_ff/vocab still shard 16-way).

Axis conventions
  batch       activations' batch dim             -> (pod, data)
  vocab       embedding/logits vocab dim         -> model   (2D-sharded tables)
  embed       param tables' d_model dim          -> fsdp axes (ZeRO-3)
  embed_tp    weight-matrix reduction dim        -> fsdp axes
  q_out/kv_out/mlp/mlp_e/lru  weight output dims -> model   (TP)
  experts     expert dim of MoE stacks           -> model   (EP)
  expert_cap  capacity dim of dispatch buffers   -> data
  kv_seq      KV-cache sequence dim              -> model   (SP / flash-decoding)
  heads       per-head params (rwkv u, ...)      -> model

The rule functions take a torch DeviceMesh or its ``{name: size}`` dict
(`models.module.mesh_shape`), so a 16 x 16 or 2 x 16 x 16 mesh is
reasoned about without 256 ranks.

Placement (`place`, the port's ``jax.device_put(x, sharding)``): each rank
cuts its own slice of a whole host or device array by the sharding's
placements and its mesh coordinate (`local_index`), moves it to its
device and wraps it as a DTensor, with no communication.  A sharding that
replicates on every mesh dim places a plain tensor: in the port's SPMD
code a replicated leaf is the local tensor every rank holds whole (the
parameters and the optimizer state), so code that is not mesh-aware runs
on it as it is.

Collectives: GSPMD has no counterpart in torch.  Where the reference
leaves collectives to XLA, the port's SPMD code runs on each rank's local
shard and calls every collective itself, through `all_reduce` and
`all_gather` here, each over named mesh dims.  The gloo backend (the CPU
group, and the one-card two-rank check of `chip_smoke.py`) has no CUDA
path for every collective, so over a gloo group a CUDA tensor is copied to
the host, reduced or gathered there and copied back; compute stays on the
card.  `counts` tallies the collectives by name.
"""
from __future__ import annotations

import collections
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import (NamedSharding, ShardCtx, ShardingRules,
                                       mesh_shape, pspec_for)
from repro_torch.tree import tree_map_with_path

Tree = Any

# collectives issued through `all_reduce` / `all_gather`, by name (tests
# and chip_smoke read it around a region)
counts: collections.Counter = collections.Counter()


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def make_rules(cfg: ModelConfig, mesh, *, fsdp: bool | None = None,
               pure_dp: bool = False) -> ShardingRules:
    if fsdp is None:
        fsdp = cfg.fsdp
    names = mesh_shape(mesh)
    fsdp_axes = tuple(a for a in cfg.fsdp_axes if a in names) if fsdp else ()
    if pure_dp:
        # batch over the whole mesh; no tensor parallelism (params replicated
        # over 'model', FSDP over 'data' kept)
        rules = {
            "batch": batch_axes(mesh) + ("model",),
            "seq": None, "vocab": None,
            "embed": fsdp_axes or None, "embed_tp": fsdp_axes or None,
            "q_out": None, "kv_out": None, "mlp": None, "mlp_e": None,
            "experts": None, "experts_r": None, "expert_cap": None,
            "experts_cap_flat": None, "embed_moe": None, "data_blk": None,
            "heads": None, "head_dim": None, "kv_heads": None, "kv_seq": None,
            "lru": None, "lru_tp": None, "layers": None, "vit": None,
        }
        return ShardingRules(rules)
    rules = {
        "batch": batch_axes(mesh),
        "seq": None,
        "vocab": "model",
        "embed": fsdp_axes or None,
        "embed_tp": fsdp_axes or None,
        "q_out": "model",
        "kv_out": "model",
        "mlp": "model",
        "mlp_e": None,
        "experts": "model",
        "experts_r": None,
        "expert_cap": "data",
        "experts_cap_flat": "model",
        "embed_moe": "data",
        "data_blk": ("pod", "data"),
        "heads": "model",
        "head_dim": None,
        "kv_heads": "model",
        "kv_seq": "model",
        "lru": "model",
        "lru_tp": None,
        "layers": None,
        "vit": None,
    }
    return ShardingRules(rules)


def make_ctx(cfg: ModelConfig, mesh) -> ShardCtx:
    return ShardCtx(mesh, make_rules(cfg, mesh))


# Cache leaf sharding: axes by rank & role.
_CACHE_AXES = {
    # kv caches [B, S, KV, Dh]
    4: ("batch", "kv_seq", "kv_heads", "head_dim"),
    # rwkv state [B, H, D, D] handled separately (see cache_pspec)
    # token-shift / lru h [B, d]
    2: ("batch", "lru"),
    # conv state [B, K-1, w]
    3: ("batch", None, "lru"),
}


def cache_pspec(path_leafname: str, shape, rules: ShardingRules, mesh,
                scanned: bool) -> tuple:
    """PartitionSpec tuple for one cache leaf. `scanned` -> leading layer
    dim."""
    rank = len(shape) - (1 if scanned else 0)
    if path_leafname == "S" and rank == 4:          # rwkv state [B,H,D,D]
        axes = ("batch", "heads", None, None)
    else:
        axes = _CACHE_AXES.get(rank, (None,) * rank)
        if rank == 4 and path_leafname not in ("k", "v"):
            axes = ("batch", None, None, None)
    if scanned:
        axes = (None,) + axes
    return pspec_for(axes, shape, rules, mesh)


def cache_shardings(cache_abs: Tree, cfg: ModelConfig, mesh) -> Tree:
    """NamedSharding tree for a cache tree (of meta tensors, or any leaves
    with a shape)."""
    rules = make_rules(cfg, mesh)

    def leaf(path, x):
        return NamedSharding(mesh, cache_pspec(str(path[-1]), tuple(x.shape),
                                               rules, mesh, cfg.scan_layers))

    return tree_map_with_path(leaf, cache_abs)


# ---------------------------------------------------------------------------
# Placement: the port's device_put
# ---------------------------------------------------------------------------

def local_index(shape, placements, coord, sizes) -> tuple:
    """This rank's slice of a [shape] array: a slice a tensor dim.  Mesh
    dims that shard one tensor dim split it in mesh-dim order (major to
    minor).  The split is even: a dim its mesh dims do not divide raises
    (the reference's rules drop such an assignment first)."""
    from torch.distributed.tensor import Shard
    lo, size = [0] * len(shape), list(shape)
    for p, c, n in zip(placements, coord, sizes):
        if isinstance(p, Shard):
            d = p.dim
            if size[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} ({size[d]} at "
                                 f"this depth) does not split evenly {n} "
                                 "ways")
            size[d] //= n
            lo[d] += c * size[d]
    return tuple(slice(a, a + s) for a, s in zip(lo, size))


def is_replicated(sharding: NamedSharding) -> bool:
    from torch.distributed.tensor import Replicate
    return all(isinstance(p, Replicate) for p in sharding.placements)


def place(x, sharding: NamedSharding):
    """A whole array (numpy, or a tensor on any device) placed by
    `sharding` on its mesh: this rank's slice on the mesh's device, as a
    DTensor, or the whole tensor where every placement replicates.  No
    collective runs: every rank holds the whole array and keeps its
    slice."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    t = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    if is_replicated(sharding):
        return t.to(dev)
    pl = sharding.placements
    idx = local_index(t.shape, pl, mesh.get_coordinate(), mesh.shape)
    # a copy of its own: a view would keep the whole array alive
    local = t[idx].to(dev).clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, pl, run_check=False)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def to_local(x):
    """A DTensor's local shard; any other leaf as it is."""
    return x.to_local() if is_dtensor(x) else x


# ---------------------------------------------------------------------------
# Collectives over named mesh dims
# ---------------------------------------------------------------------------

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
    all_reduce, into a new tensor."""
    group, size = _group(mesh, dims)
    if size == 1:
        return t.clone()
    counts[f"all_reduce_{op}"] += 1
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    buf = t.detach().to("cpu", copy=True) if _staged(t, group) \
        else t.detach().clone()
    dist.all_reduce(buf, op=red, group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, mesh, dims, axis: int = 0) -> torch.Tensor:
    """The ranks' `t` of mesh dims `dims` concatenated along `axis`, in
    rank order of those dims: one all_gather."""
    group, size = _group(mesh, dims)
    if size == 1:
        return t.clone()
    counts["all_gather"] += 1
    src = t.detach().movedim(axis, 0).contiguous()
    if _staged(t, group):
        src = src.cpu()
    out = src.new_empty((size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device).movedim(0, axis)


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()
