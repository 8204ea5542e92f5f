"""Dry-run cell runner of the port (counterpart of `repro.launch.dryrun_lib`).

A cell is one (arch, shape) pair of the shape suite, on one card or on
one of the reference's production meshes.  `run_cell` builds the cell's
step on the `meta` device (`launch.steps`), runs it once there under the
counter (`launch.costing.count_step`: FLOPs, bytes, parts, and the peak
that torch's `MemTracker` follows), and writes the record to
`<out>/<arch>_<shape>_<mesh>[_tag].json`.  Nothing is allocated and
nothing is drawn: a full-size model (kimi-k2's 1.03 T parameters) runs as
shapes.  No kernel wrapper takes a meta tensor; the steps take the plain
versions.

On a mesh (`single`: 16 x 16, `multi`: 2 x 16 x 16) the step is the
sharded one (`make_*_step(..., mesh=)`), built over a one-process `fake`
process group of 256 or 512 ranks (`fake_group`) and run on rank 0's
local shards (`rank_args`): its FLOPs, bytes, peak and arguments are one
rank's, and its collectives are counted with their result bytes by kind
(`collectives.counts_bytes`; on meta a collective asks no rank).
`count_rank` is the same count on any mesh, a real group's included.

The record keeps the reference's keys where they mean the same thing
(`arch`, `shape`, `mesh`, `mesh_shape`, `kind`, `overrides`, `tag`,
`status`, `error`, `traceback`, `total_s`, `cost_analysis`, `parts`,
`memory`, `roofline`).  `memory` holds the exact bytes of the arguments
(parameters, optimizer state, batch, cache) and of the new outputs, the
reckoned peak, and whether that fits one 80 GB card; `roofline` holds the
least times reckoned against the card's published peaks.
"""
from __future__ import annotations

import contextlib
import json
import time

import torch
import traceback
from pathlib import Path

from repro_torch import collectives

from repro_torch.configs import SHAPES, ShapeSuite, get_config, smoke_config
from repro_torch.launch import costing
from repro_torch.launch import steps as steps_lib
from repro_torch.models import get_model
from repro_torch.models.module import abstract
from repro_torch.sharding import local_index, to_local
from repro_torch.tree import tree_leaves, tree_map

COUNTS = ("FlopCounterMode: the matmul-class aten ops (mm, bmm, addmm, "
          "baddbmm, convolution, attention), 2 FLOPs a multiply-add, no "
          "elementwise op; bytes: each aten op's inputs and outputs, the "
          "distinct elements each addresses, views none (an unfused upper "
          "bound)")
PEAK_HOW = ("torch.distributed._tools.mem_tracker.MemTracker over the step on "
            "meta tensors, the arguments live from the start: the tensors' "
            "storage bytes, without the caching allocator's rounding and "
            "fragmentation")


# the reference's production meshes: name -> multi_pod
MESHES = {"single": False, "multi": True}
COLLECTIVE_HOW = ("each collective the rank's step issues through "
                  "`collectives.all_reduce` / `all_gather`, its result's "
                  "bytes (the reference's result-shape bytes a kind)")


def build_step(cfg, shape, device="meta", mesh=None) -> steps_lib.BuiltStep:
    if shape.kind == "train":
        return steps_lib.make_train_step(cfg, shape=shape, mesh=mesh)
    if shape.kind == "prefill":
        return steps_lib.make_prefill_step(cfg, shape, device, mesh=mesh)
    return steps_lib.make_decode_step(cfg, shape, device, mesh=mesh)


@contextlib.contextmanager
def fake_group(world: int):
    """A one-process `fake` process group of `world` ranks, this process
    rank 0, destroyed on exit: a mesh over it builds, and a collective on
    it returns without talking to anyone (the dry-run's collectives run on
    meta tensors and do not reach it)."""
    import torch.distributed as dist
    # registers the "fake" backend (torch's own, in its testing package)
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: the "
                           "dry-run's fake group would replace it")
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_meta(x, sharding, mesh):
    """Rank `mesh.get_coordinate()`'s shard of a meta leaf, as a meta
    tensor of its own (no view of the whole)."""
    idx = local_index(x.shape, sharding.placements, mesh.get_coordinate(),
                      mesh.shape)
    return torch.empty([sl.stop - sl.start for sl in idx], dtype=x.dtype,
                       device="meta")


def rank_args(built: steps_lib.BuiltStep, kind: str, mesh) -> tuple:
    """A sharded step's meta arguments as this rank holds them: the
    parameters, optimizer state and cache its local shards (by the
    `BuiltStep`'s shardings), the batch and decode inputs whole (the
    sharded steps take them whole and cut their rows)."""
    sh, a = built.shardings, built.args_abstract
    local = lambda tree, shs: tree_map(
        lambda x, s: _local_meta(x, s, mesh), tree, shs)
    if kind == "train":
        return (local(a[0], sh["params"]), local(a[1], sh["opt"]), a[2], a[3])
    if kind == "prefill":
        return (local(a[0], sh["params"]), a[1])
    return (local(a[0], sh["params"]), a[1], local(a[2], sh["cache"]), a[3])


def argument_bytes(kind: str, args: tuple) -> dict:
    """The bytes of a step's arguments by what they are."""
    tb = costing.tree_bytes
    out = {"params": tb(args[0])}
    if kind == "train":
        out.update(opt_state=tb(args[1]), batch=tb(args[2]))
    elif kind == "prefill":
        out.update(batch=tb(args[1]))
    else:
        out.update(batch=tb(args[1]) + tb(args[3]), cache=tb(args[2]))
    out["total"] = sum(out.values())
    return out


def _tags(kind: str, args: tuple) -> list:
    tags = costing.part_tags(args[0])
    if kind == "train":      # each moment's leaf keeps its parameter's part
        for sub in args[1].values():
            tags += costing.part_tags(sub)
    return tags


def count_cell(built: steps_lib.BuiltStep, kind: str, args=None) -> dict:
    """Run the built step once on its meta arguments (`args`, default the
    whole ones) under the counter, with MemTracker's peak where that runs
    on the step (else peak_bytes None and the reason)."""
    args = built.args_abstract if args is None else args
    tags = _tags(kind, args)
    try:
        return costing.count_step(built.fn, *args, tagged=tags, peak=True,
                                  track=list(args))
    except Exception as e:                          # noqa: BLE001
        res = costing.count_step(built.fn, *args, tagged=tags)
        res["peak_bytes"] = None
        res["peak_error"] = f"{type(e).__name__}: {e}"
        return res


def count_rank(built: steps_lib.BuiltStep, kind: str, mesh,
               args=None) -> dict:
    """`count_cell` of a sharded step on this rank of `mesh` (its local
    meta shards, `rank_args`, unless `args` are given: a real group's
    placed tensors), with the collectives it issued: "collectives"
    {kind: count} and "collectives_raw" {kind: result bytes}."""
    args = rank_args(built, kind, mesh) if args is None else args
    collectives.counts.clear()
    collectives.counts_bytes.clear()
    c = count_cell(built, kind, args)
    c["args"] = args
    c["collectives"] = dict(collectives.counts)
    c["collectives_raw"] = dict(collectives.counts_bytes)
    return c


def run_cell(arch: str, shape_name: str, out_dir: str,
             with_parts: bool = True, cfg_overrides: dict | None = None,
             tag: str = "", smoke: bool = False, mesh: str = "card") -> dict:
    """Count one cell on meta and write its record (see the module
    docstring).  `smoke` takes the arch's reduced `smoke_config` at the
    shape's batch and length (a CPU test's size: the record says so).
    `mesh` is "card" (one card), or "single" / "multi": the reference's
    16 x 16 / 2 x 16 x 16 meshes over a fake process group, rank 0's
    count."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_config(cfg)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh,
                 "mesh_shape": {"card": 1}, "kind": shape.kind,
                 "overrides": cfg_overrides or {}, "tag": tag,
                 "smoke": smoke}
    t0 = time.time()
    try:
        if mesh == "card":
            _count_into(rec, cfg, shape, with_parts, t0)
        else:
            from repro_torch.launch.mesh import (PRODUCTION_WORLD,
                                                 make_production_mesh)
            multi = MESHES[mesh]
            with fake_group(PRODUCTION_WORLD[multi]):
                m = make_production_mesh(multi_pod=multi, device="cpu")
                rec["mesh_shape"] = dict(zip(m.mesh_dim_names, m.shape))
                rec["rank"] = 0
                _count_into(rec, cfg, shape, with_parts, t0, m)
        rec["status"] = "ok"
    except Exception as e:                          # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    path = out / f"{arch}_{shape_name}_{mesh}{suffix}.json"
    path.write_text(json.dumps(rec, indent=1, default=str))
    print(f"[dryrun] {arch} {shape_name} {mesh} -> {rec['status']} "
          f"({rec['total_s']}s) {path}")
    return rec


def _count_into(rec: dict, cfg, shape, with_parts: bool, t0: float,
                mesh=None) -> None:
    """Build and count the cell's step (one card, or this rank of `mesh`)
    and write its counts into `rec`."""
    built = build_step(cfg, shape, mesh=mesh)
    rec["build_s"] = round(time.time() - t0, 1)
    t1 = time.time()
    if mesh is None:
        c = count_cell(built, shape.kind)
        args = built.args_abstract
    else:
        c = count_rank(built, shape.kind, mesh)
        args = c["args"]
        rec["collectives"] = c["collectives"]
        rec["collectives_raw"] = c["collectives_raw"]
    rec["count_s"] = round(time.time() - t1, 1)
    arg_ids = {id(t) for t in tree_leaves(list(args))}
    new_out = [t for t in tree_leaves(c["out"]) if id(t) not in arg_ids]
    rec["cost_analysis"] = {"flops": float(c["flops"]),
                            "bytes": float(c["bytes"]), "ops": c["ops"],
                            "counts": COUNTS}
    if mesh is not None:
        rec["cost_analysis"]["collectives"] = COLLECTIVE_HOW
    if with_parts:
        rec["parts"] = c["parts"]
    peak = c["peak_bytes"]
    arg_b = argument_bytes(shape.kind, args)
    out_b = costing.tree_bytes([to_local(t) for t in new_out])
    fits = (peak <= costing.CARD_BYTES if peak is not None
            else (False if arg_b["total"] + out_b > costing.CARD_BYTES
                  else None))
    rec["memory"] = {"argument_bytes": arg_b, "output_bytes": out_b,
                     "peak_bytes": peak,
                     "peak_how": PEAK_HOW if peak is not None
                     else f"not reckoned: {c['peak_error']}",
                     "card_bytes": costing.CARD_BYTES,
                     "fits_one_card": fits}
    n_chips = 1 if mesh is None else mesh.size()
    rec["roofline"] = costing.roofline(
        c["flops"], c["bytes"], costing.model_flops(cfg, shape),
        costing.model_param_counts(cfg), n_chips=n_chips,
        collective_bytes=sum(c.get("collectives_raw", {}).values()))
    print({k: rec["cost_analysis"][k] for k in ("flops", "bytes")},
          {"peak_bytes": peak, "fits_one_card": fits})


def reckon_prefill(cfg, batch: int, T: int, max_seq: int, points: tuple,
                   peak_points: tuple | None = None,
                   peak_layers: int = 0) -> dict:
    """FLOPs and peak bytes of a prefill of [batch, T] tokens with room for
    max_seq positions, reckoned from meta counts at shorter lengths (a
    meta prefill of T = 524,256 runs tens of millions of ops).  Both are
    affine in T for RWKV6 and the RG-LRU LM, whose tensors are [B, T, ...]
    or of a fixed size (a WKV chunk, a flash block, the ring, the state):

    * FLOPs: the line through the full model's counts at `points`;
    * the peak: the line through the counts at `peak_points` (default
      `points`) of the model cut to `peak_layers` layers (0: not cut),
      plus the exact bytes of the cut layers' parameters and decode
      state.  A peak is the largest of several affine terms, so its points
      must lie where the [B, T, ...] terms already lead (past the fixed
      transients, such as the f32 head widened for the last position's
      logits): long ones, affordable at a cut depth, since every layer
      holds the same transients.

    Returns {"flops", "peak_bytes", "argument_bytes", "lines" ({"flops",
    "peak_bytes"}: [a, b], the value at length t being a + b t),
    "points"}."""
    def counts(c, t, peak):
        built = steps_lib.make_prefill_step(c, ShapeSuite("p", max_seq, batch,
                                                          "prefill"))
        tokens = torch.empty((batch, t), dtype=torch.int32, device="meta")
        args = (built.args_abstract[0], {"tokens": tokens})
        res = costing.count_step(built.fn, *args, peak=peak,
                                 track=list(args))
        return res["peak_bytes"] if peak else res["flops"]

    def line(f, t1, t2, t):
        a, b = f(t1), f(t2)
        return a + (b - a) * (t - t1) // (t2 - t1)

    cut = cfg.replace(n_layers=peak_layers) if peak_layers else cfg
    pp = peak_points or points
    got_f = {t: counts(cfg, t, False) for t in points}
    got_p = {t: counts(cut, t, True) for t in pp}
    api = get_model(cfg)
    fixed = lambda c: (costing.tree_bytes(abstract(api.specs(c)))
                       + costing.tree_bytes(api.init_cache(c, batch, max_seq,
                                                           "meta")))
    delta = fixed(cfg) - fixed(cut)
    slope = lambda got, t1, t2: (got[t2] - got[t1]) / (t2 - t1)
    f_b, p_b = slope(got_f, *points), slope(got_p, *pp)
    out = {"flops": line(got_f.get, *points, T),
           "peak_bytes": line(got_p.get, *pp, T) + delta,
           # value(t) = a + b * t, for reckoning other lengths
           "lines": {"flops": [got_f[points[0]] - f_b * points[0], f_b],
                     "peak_bytes": [got_p[pp[0]] - p_b * pp[0] + delta, p_b]},
           "argument_bytes": (costing.tree_bytes(abstract(api.specs(cfg)))
                              + batch * T * 4),
           "points": {"flops": got_f, "peak_bytes": got_p,
                      "peak_layers": peak_layers or cfg.n_layers,
                      "cut_bytes": delta}}
    return out
