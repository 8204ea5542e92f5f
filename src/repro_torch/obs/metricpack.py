"""Device-side metrics packing: every runtime scalar, one readback.

Counterpart of `repro.obs.metricpack`.  The paper's efficiency claim rides
on runtime-varying quantities — the measured activity sparsity omega-hat
and the live parameter density drive the w~ b~^2 n^2 p cost — so a
credible run must MEASURE them, every window, without perturbing the
computation or adding host syncs.  `MetricPack` is a declarative set of
device scalars:

- each field is ``(name, fn)`` where ``fn(env) -> 0-d float32 tensor``
  reads the update chunk's environment (window loss, gradient tree,
  per-step stats, the post-update carry, guard clip factor / health
  bits);
- ``pack(env)`` stacks every field into ONE ``[F]`` float32 tensor on the
  loss's device, which the chunk returns instead of its metrics, so all F
  scalars cost a single device->host readback per window;
- ``unpack(vec)`` is that readback, mapping the vector back to
  ``{name: float}``.

Fields are *pure observers*: they only reduce tensors the chunk already
computed, out of place, and `stack` copies the reductions into a new
tensor, so nothing the chunk returns is written or aliased and the
instrumented chunk's carry / optimizer state are BITWISE the bare ones
(pinned in tests/test_torch_obs.py).  No field reads a value back: a
field whose source is absent for this engine (no compact `idx` buffer, no
rewirable column mask) packs NaN, built on the loss's device — `unpack`
surfaces it as NaN and the JSONL writer drops it, so one pack definition
serves every engine.  On a sharded carry every field is the whole
batch's, the same on every rank: the chunk's loss, gradients and stats
are (`learner.read_window`), and the K_b fields read the whole batch's
live-row counts from ``stats["kb"]``.

This module imports nothing from `repro_torch.runtime` (the runtime
imports it).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.collectives import all_reduce
from repro_torch.kernels._build import is_transformed
from repro_torch.tree import tree_leaves

Tree = Any

_NAN = float("nan")


def global_norm(tree, *, mesh=None, rep=None) -> torch.Tensor:
    """sqrt(sum of squares) over every tensor leaf, in float32 — THE clip
    norm of the stream guard, so the packed `grad_norm` equals the norm the
    clip decision used.  A multi-tensor reduction (`get_total_norm`, the
    foreach kernels where the device has them): one norm a leaf, then the
    norm of those, with no copy of the tree (a leaf of another dtype is
    widened to float32 first, as the reference widens every leaf).  Under
    `torch.func.vmap` (a stream fleet's slots), which has no batching rule
    for the foreach kernels, the same two stages run one reduction a leaf,
    each slot getting its own norm.

    Under a mesh, `tree` holds each rank's local shards and `rep` (a tree
    of the same leaves) how many ranks hold each leaf's shard alike: the
    local sums of squares, each over its leaf's `rep`, summed over the
    whole mesh in one all_reduce, count every element of the whole tree
    once."""
    if mesh is not None:
        sq = sum(torch.linalg.vector_norm(x.float()).square() / r
                 for x, r in zip(tree_leaves(tree), tree_leaves(rep)))
        return all_reduce(sq, mesh, tuple(mesh.mesh_dim_names)).sqrt()
    leaves = [x if x.dtype == torch.float32 else x.float()
              for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    if any(map(is_transformed, leaves)):
        norms = [torch.linalg.vector_norm(x) for x in leaves]
        return torch.linalg.vector_norm(torch.stack(norms))
    return torch.nn.utils.get_total_norm(leaves, 2.0)


def _device(env) -> torch.device:
    return torch.as_tensor(env["loss"]).device


def _full(env, value: float) -> torch.Tensor:
    """A constant on the loss's device: a fill, never a host copy."""
    return torch.full((), value, dtype=torch.float32, device=_device(env))


def _scalar(env, v) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
        return _full(env, float(v))
    return v.to(device=_device(env), dtype=torch.float32).reshape(())


def _stat_mean(key):
    def fn(env):
        stats = env.get("stats") or {}
        if key not in stats:
            return _full(env, _NAN)
        return _scalar(env, stats[key].float().mean())
    return fn


def _f_loss(env):
    return _scalar(env, env["loss"])


def _f_grad_norm(env):
    if "grad_norm" in env:                  # guard chunk already computed it
        return _scalar(env, env["grad_norm"])
    grads = env.get("grads")
    if grads is None:
        return _full(env, _NAN)
    return _scalar(env, global_norm(grads))


def _f_overflow(env):
    stats = env.get("stats") or {}
    if "overflow" not in stats:
        return _full(env, _NAN)             # engine doesn't track capacity
    # max, not mean: any nonzero step means the window's gradients are no
    # longer exact — same convention as the chunk metrics
    return _scalar(env, stats["overflow"].float().max())


def _f_live_col_frac(env):
    """Live fraction of the influence column axis.  Read from the carry for
    rewirable carries — the mask state rides in carry['rw'] — NaN
    otherwise (the static layout is a config constant, reported host-side
    by `OnlineTrainer.carry_nbytes`)."""
    carry = env.get("carry")
    rw = carry.get("rw") if isinstance(carry, dict) else None
    if not isinstance(rw, dict):
        return _full(env, _NAN)
    if "cl" in rw:
        live = rw["cl"]["live"]
    elif "colm" in rw:
        live = rw["colm"]
    elif "colms" in rw:
        live = rw["colms"][-1]
    else:
        return _full(env, _NAN)
    return _scalar(env, live.float().mean())


def _kb_counts(carry):
    """Per-(buffer, example) live-row counts of a compact influence carry,
    or None off the compact backends — the device twin of
    `OnlineTrainer.row_stats`.  `idx` is one [B, K] tensor or a tuple of
    them, one a layer."""
    if not isinstance(carry, dict):
        return None
    bufs = []
    for holder in (carry, carry.get("state") or {}):
        if not isinstance(holder, dict):
            continue
        idx = holder.get("idx")
        if idx is None:
            continue
        bufs += list(idx) if isinstance(idx, (tuple, list)) else [idx]
    if not bufs:
        return None
    kb = [(b >= 0).float().sum(dim=-1).reshape(-1) for b in bufs]
    return kb[0] if len(kb) == 1 else torch.cat(kb)


def _f_kb(reduce):
    def fn(env):
        # the three K_b fields share one count per pack call; a sharded
        # carry's learner hands the whole batch's counts in the stats (its
        # carry holds this rank's rows only)
        if "_kb" not in env:
            stats = env.get("stats") or {}
            env["_kb"] = stats["kb"] if "kb" in stats \
                else _kb_counts(env.get("carry"))
        kb = env["_kb"]
        if kb is None:
            return _full(env, _NAN)
        return _scalar(env, {"min": torch.min, "mean": torch.mean,
                             "max": torch.max}[reduce](kb))
    return fn


def _f_env(key, default):
    def fn(env):
        return _scalar(env, env.get(key, default))
    return fn


# the standard catalog, in packed order (the reference's, field for field)
DEFAULT_FIELDS = (
    ("loss", _f_loss),                       # window loss (sum of 1/t_total-scaled steps)
    ("grad_norm", _f_grad_norm),             # global gradient norm, pre-clip-scale
    ("act_sparsity", _stat_mean("alpha")),   # omega-hat: mean forward activity sparsity
    ("bwd_sparsity", _stat_mean("beta")),    # beta-hat: mean backward (pseudo-deriv) sparsity
    ("overflow", _f_overflow),               # compact-capacity overflow (max over window)
    ("live_col_frac", _f_live_col_frac),     # live influence columns / total (rewirable)
    ("kb_min", _f_kb("min")),                # ragged per-example active rows K_b
    ("kb_mean", _f_kb("mean")),
    ("kb_max", _f_kb("max")),
    ("clip_factor", _f_env("clip_factor", 1.0)),  # guard norm-clip scale (1 = untouched)
    ("health", _f_env("health", 0.0)),       # guard finiteness bitmask (0 = healthy)
)


class MetricPack:
    """An ordered, declarative set of device scalar fields."""

    def __init__(self, fields=DEFAULT_FIELDS):
        self.fields = tuple(fields)
        self.names = tuple(n for n, _ in self.fields)
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"duplicate metric names: {self.names}")

    @classmethod
    def default(cls, exclude: tuple = ()) -> "MetricPack":
        return cls(tuple(f for f in DEFAULT_FIELDS if f[0] not in exclude))

    def pack(self, env: dict) -> torch.Tensor:
        """[F] float32 on the loss's device — call inside the update chunk.
        env keys (all optional except 'loss'): loss, grads, stats, carry,
        grad_norm, clip_factor, health.  Issues device ops only: no field
        reads a value back."""
        env = dict(env)                 # the fields' shared scratch
        return torch.stack([fn(env) for _, fn in self.fields])

    def unpack(self, vec) -> dict:
        """Fetched [F] (or [..., F]) vector -> {name: float} (leading axes
        -> arrays).  THE window readback: one device->host copy, which
        waits for the device to finish the chunk."""
        if isinstance(vec, torch.Tensor):
            vec = vec.detach().cpu().numpy()
        a = np.asarray(vec, dtype=np.float32)
        if a.shape[-1] != len(self.names):
            raise ValueError(f"packed vector has {a.shape[-1]} fields, "
                             f"pack defines {len(self.names)}")
        if a.ndim == 1:
            return {n: float(a[i]) for i, n in enumerate(self.names)}
        return {n: a[..., i] for i, n in enumerate(self.names)}

