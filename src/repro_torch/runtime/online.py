"""True online training over an unbounded stream, in PyTorch.

Counterpart of `repro.runtime.online`: :class:`OnlineTrainer` consumes a
step-keyed stream `(x_t, y_t) = stream(t)` and applies an optimizer update
every `update_every` steps — mid-sequence; no sequence boundary exists.
The per-update work is `online_update_chunk`: the learner stepped over the
k-step window, `learner.grads` + optimizer + `reset_grads` (the influence
state carries over).  The trainer checkpoints the full learner carry
(influence buffer, activity, gradient accumulators, loss scale), the
optimizer state and the stream position, so a restarted worker resumes
mid-stream to the same gradients, bit for bit on one device.

The carry of a stacked learner holds per-layer tuples (`a`, `vals`, `idx`,
`M`), checkpointed under the JAX package's leaf names (`carry__vals__0`,
...).  Not ported yet: rewire (ROADMAP Queue 1 item 8), the stream guard and its
fault plan (item 9), telemetry and the packed window metrics (item 11).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.ckpt import dtype_name
from repro_torch.runtime.trainer import (InjectedFailure, default_ckpt_dir,
                                         scalar_metrics)
from repro_torch.tree import tree_leaves

Tree = Any


def stream_grads(learner, carry: Tree, xs: torch.Tensor, ys: torch.Tensor):
    """Drive the learner over a [k]-step window and read out the gradient.

    Returns (carry, loss, grads, stats) with every stat stacked over the
    window — the online code path's gradient, without the optimizer."""
    per_step = []
    for t in range(xs.shape[0]):
        carry, out = learner.step(carry, xs[t], ys[t])
        per_step.append(out.stats)
    stats = {k: torch.stack([s[k] for s in per_step]) for k in per_step[0]}
    return carry, carry["loss"], learner.grads(carry), stats


def online_update_chunk(learner, opt, carry: Tree, opt_state: Tree,
                        xs: torch.Tensor, ys: torch.Tensor, upd: int):
    """One online update: step through the window, update params
    mid-stream, reset the accumulators.  Returns (carry, opt_state,
    metrics) with loss / alpha / beta / overflow as device scalars."""
    carry, loss, grads, stats = stream_grads(learner, carry, xs, ys)
    params, opt_state = opt.update(grads, opt_state,
                                   learner.params_of(carry), upd)
    carry = learner.reset_grads(carry, params)
    metrics = {"loss": loss}
    for k in ("alpha", "beta"):
        if k in stats:
            metrics[k] = stats[k].mean()
    if "overflow" in stats:
        # max, not mean: any nonzero step means the window's gradients are
        # no longer exact
        metrics["overflow"] = stats["overflow"].max()
    return carry, opt_state, metrics


@dataclasses.dataclass
class OnlineTrainerConfig:
    total_steps: int = 170          # stream steps (not updates)
    update_every: int = 1           # optimizer update every k stream steps
    ckpt_every: int = 0             # checkpoint every N updates (0 = off)
    ckpt_dir: str | None = None     # None: default_ckpt_dir(...online...)
    keep: int = 3
    log_every: int = 10             # keep metrics every N updates
    fail_at_update: int = -1        # failure injection (once)
    metrics_path: str | None = None
    seed: int = 0
    t_total: float | None = None    # per-step loss scale (None: update_every)
    straggler_factor: float = 3.0   # window counts as straggler past EMA * f


class OnlineTrainer:
    """Streaming trainer over a learner: mid-sequence updates, O(1) memory,
    carry-inclusive checkpoints.  Works with `run_with_restart`.

    stream: a step-keyed callable `t -> (x_t [B, ...], y_t [B])` of numpy
    arrays, so a restarted worker replays its exact windows; each window is
    stacked on the host and copied to `device` once.

    Learner state outside the carry (the column layout, the pallas
    backend's block masks, the fused backend's gate segments) depends on
    the masks only, never on the stream position: a restarted trainer built
    on the same learner and masks rebuilds it as it was.
    """

    def __init__(self, cfg: OnlineTrainerConfig, learner, opt, params: Tree,
                 masks: Tree | None, stream: Callable[[int], tuple], *,
                 device: torch.device | str):
        self.cfg = cfg
        self.learner = learner
        self.opt = opt
        self.stream = stream
        self.device = torch.device(device)
        x0, y0 = stream(0)
        tt = cfg.t_total if cfg.t_total is not None else float(cfg.update_every)
        self.carry = learner.init(params, masks,
                                  (self._to(x0), self._to(y0)), t_total=tt)
        self.opt_state = opt.init(params)
        self.step = 0                     # stream position
        self.update = 0                   # optimizer updates applied
        self.rewire_events = 0            # rewire is ROADMAP Queue 1 item 8
        # the JAX package's RNG key data for `seed` ([0, seed]).  It is
        # checkpointed so that the leaf set is the JAX package's, and
        # carried unchanged: the JAX package folds it every update but
        # nothing in either package consumes it, so it is never folded here
        self.key = np.array([0, cfg.seed], dtype=np.uint32)
        self.ckpt = (CheckpointManager(
            cfg.ckpt_dir or default_ckpt_dir("repro_torch_online_ckpt"),
            keep=cfg.keep) if cfg.ckpt_every > 0 else None)
        self.metrics: list[dict] = []     # every log_every-th window
        self.windows: list[dict] = []     # every window: metrics + wall ms
        self.stragglers = 0
        self._failed_once = False
        self._dt_ema: float | None = None

    def _to(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _gather(self, start: int, k: int):
        xs, ys = zip(*(self.stream(start + i) for i in range(k)))
        return self._to(np.stack(xs)), self._to(np.stack(ys))

    # -- checkpoint/restore: carry + opt + stream position ------------------

    def _ckpt_tree(self) -> Tree:
        return {"carry": self.carry, "opt": self.opt_state,
                "pos": np.int32(self.step),
                "rewire_events": np.int32(self.rewire_events),
                "key": self.key}

    def save(self):
        if self.ckpt is not None:
            self.ckpt.save(self.update, self._ckpt_tree(),
                           extra={"step": self.step})

    def try_resume(self) -> bool:
        if self.ckpt is None or self.ckpt.latest_step() < 0:
            return False
        tree, upd = self.ckpt.restore(self._ckpt_tree())
        if tree is None:
            return False
        self.carry, self.opt_state = tree["carry"], tree["opt"]
        self.step = int(tree["pos"])
        # the update count is the checkpoint's step: adamw's bias
        # correction reads it
        self.update = upd
        self.rewire_events = int(tree["rewire_events"])
        self.key = tree["key"]
        return True

    def row_stats(self) -> dict | None:
        """Per-example active-row stats of a compact influence carry, or
        None off the compact backends: K_b = live rows of example b;
        'ragged_utilization' = Sigma_b K_b / (B * K_max), pooled over the
        layers of a stacked carry as in the JAX package, whose per-layer
        stats follow under 'layers'.  Also reports the carry dtype."""
        idx, vals = self.carry.get("idx"), self.carry.get("vals")
        if idx is None:
            return None
        stacked = isinstance(idx, tuple)
        idxs = idx if stacked else (idx,)
        kbs = [(i >= 0).sum(dim=1).cpu().numpy() for i in idxs]

        def stats(kb, cap):
            return {"k_min": int(kb.min()),
                    "k_mean": round(float(kb.mean()), 2),
                    "k_max": int(kb.max()),
                    "ragged_utilization": round(float(kb.sum()) / cap, 4)}

        out = stats(np.concatenate(kbs), sum(i.numel() for i in idxs))
        out["influence_dtype"] = dtype_name(vals[0] if stacked else vals)
        if stacked:
            out["layers"] = [stats(kb, i.numel()) for kb, i in zip(kbs, idxs)]
        return out

    # -- loop ---------------------------------------------------------------

    def _watch_straggler(self, dt: float):
        """EMA watchdog over window wall time: a window slower than
        straggler_factor x the EMA counts as a straggler."""
        if self._dt_ema is None:
            self._dt_ema = dt
            return
        if dt > self.cfg.straggler_factor * self._dt_ema:
            self.stragglers += 1
        self._dt_ema = 0.9 * self._dt_ema + 0.1 * dt

    def run(self) -> dict:
        cfg = self.cfg
        while self.step < cfg.total_steps:
            if self.update == cfg.fail_at_update and not self._failed_once:
                self._failed_once = True
                if self.ckpt is not None:
                    # land the pending write first, so that the restart
                    # resumes from it and replays the same windows on every
                    # run; a real crash can lose that write, and
                    # valid_steps covers that
                    self.ckpt.wait()
                raise InjectedFailure(
                    f"injected failure at update {self.update} "
                    f"(stream step {self.step})")
            k = min(cfg.update_every, cfg.total_steps - self.step)
            start = self.step
            t0 = time.perf_counter()
            xs, ys = self._gather(start, k)
            self.carry, self.opt_state, m = online_update_chunk(
                self.learner, self.opt, self.carry, self.opt_state, xs, ys,
                self.update)
            # THE window readback: blocks until the device finished the window
            m = scalar_metrics(m)
            dt = time.perf_counter() - t0
            self._watch_straggler(dt)
            self.step = start + k
            self.update += 1
            self.windows.append({"update": self.update, "ms": dt * 1e3, **m})
            if self.ckpt is not None and self.update % cfg.ckpt_every == 0:
                self.save()
            if (self.update % cfg.log_every == 0
                    or self.step >= cfg.total_steps):
                rec = {"update": self.update, "step": self.step,
                       "dt_s": round(dt, 4), **m}
                self.metrics.append(rec)
                if cfg.metrics_path:
                    with open(cfg.metrics_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
        self.save()
        if self.ckpt is not None:
            self.ckpt.wait()
        nbytes = carry_nbytes(self.carry)
        out = {"final_step": self.step, "updates": self.update,
               "metrics": self.metrics, "rewire_events": self.rewire_events,
               # every influence column is live until rewire exists
               "carry_bytes": nbytes, "carry_live_bytes": nbytes,
               "stragglers": self.stragglers, "windows": self.windows}
        rs = self.row_stats()
        if rs is not None:
            out["row_stats"] = rs
        return out


def carry_nbytes(carry: Tree) -> int:
    """Total bytes held by the learner carry — the O(1)-in-stream-length
    memory claim, as a number."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(carry)
                   if isinstance(t, torch.Tensor)))
