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

Collectives: the counted and the differentiable ones live in
`collectives`, which knows nothing of models or rules; they are
re-exported here (`all_reduce`, `all_gather`, `counts`, ...), so the
callers of `sharding.all_reduce` and the rest stay as they are.

Serving over a mesh (`serve_layout`): the shardings, the ShardCtx and the
batch split that the serve step builders (`launch.steps`) and the serving
engine (`runtime.serving`) share.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.collectives import (  # noqa: F401  (re-exported)
    BUCKET_BYTES, all_gather, all_reduce, barrier, copy_to, counts,
    gather_for_use, gather_from, group_index, group_size, reduce_from,
    reduce_grads, split_to)
from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import (NamedSharding, ShardCtx, ShardingRules,
                                       mesh_shape, pspec_for, tree_shardings)
from repro_torch.tree import tree_map, tree_map_with_path

Tree = Any

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
    with a shape).  With `cfg.scan_layers` a leaf has a leading layer dim,
    but for the RG-LRU LM's remainder layers (`rem`), which are a list in
    either layout: the reference reads their [B, w] state as stacked too,
    and so replicates it (ROADMAP Queue 3, fault 12); here it splits by
    channel as the units' state does."""
    rules = make_rules(cfg, mesh)

    def leaf(path, x):
        scanned = cfg.scan_layers and path[0] != "rem"
        return NamedSharding(mesh, cache_pspec(str(path[-1]), tuple(x.shape),
                                               rules, mesh, scanned))

    return tree_map_with_path(leaf, cache_abs)


# ---------------------------------------------------------------------------
# Serving over a mesh
# ---------------------------------------------------------------------------

def split_dims(mesh, axes: tuple, rows: int) -> tuple:
    """The mesh dims of `axes` that split `rows` rows: trailing ones shed
    until they divide (`launch.steps.batch_shardings`' rule)."""
    sizes = mesh_shape(mesh)
    while axes and rows % math.prod(sizes[a] for a in axes):
        axes = axes[:-1]
    return axes


def serve_layout(cfg: ModelConfig, api, batch: int, seq: int, mesh):
    """The shardings of a serve step over a mesh (the rules without pure
    DP) for `batch` rows and a cache of `seq` positions: {"params",
    "cache", "logits", "rows"}; its ShardCtx; and the mesh dims the rows
    split on.  `api` is the model's (`models.get_model`)."""
    rules = make_rules(cfg, mesh)
    dims = split_dims(mesh, batch_axes(mesh), batch)
    row = dims if len(dims) > 1 else (dims[0] if dims else None)
    vocab = "model" if cfg.vocab_size % mesh_shape(mesh)["model"] == 0 \
        else None
    sh = {"params": tree_shardings(api.specs(cfg), rules, mesh),
          "cache": cache_shardings(api.init_cache(cfg, batch, seq, "meta"),
                                   cfg, mesh),
          "logits": NamedSharding(mesh, (row, vocab)),
          "rows": NamedSharding(mesh, (row,))}
    return sh, ShardCtx(mesh, rules, batch=dims, seq=seq), dims


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


def placed_dims(sharding: NamedSharding) -> tuple:
    """The mesh dims that shard a leaf of `sharding`, in mesh order."""
    names = tuple(mesh_shape(sharding.mesh))
    used = set()
    for e in sharding.spec:
        if e is not None:
            used.update((e,) if isinstance(e, str) else e)
    return tuple(n for n in names if n in used)


def from_local(local: torch.Tensor, sharding: NamedSharding):
    """A rank's local shard as the leaf `place` would have made: a DTensor,
    or the tensor itself where every placement replicates."""
    from torch.distributed.tensor import DTensor
    if is_replicated(sharding):
        return local
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False)


def place_tree(tree: Tree, shardings: Tree) -> Tree:
    return tree_map(place, tree, shardings)


def local_tree(tree: Tree) -> Tree:
    """Every leaf's local tensor (the DTensor's own storage)."""
    with torch.no_grad():
        return tree_map(to_local, tree)
