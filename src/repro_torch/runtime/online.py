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
...).  Rewire events (`rewire_schedule`, `repro_torch.sparsity`) fire at
update boundaries; the stream guard (`guard`, `fault_plan`,
`repro_torch.runtime.guard`) checks every window, rolls back and replays.
Telemetry (`telemetry`, `repro_torch.obs`): the registry holds every count
the result dict reports; with active telemetry the update chunk packs the
window's scalars into one `MetricPack` vector, read back once, and each
window, rewire event and checkpoint write becomes an event and a span.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.ckpt import dtype_name
from repro_torch.obs import MetricPack, Telemetry
from repro_torch.runtime.trainer import (InjectedFailure, default_ckpt_dir,
                                         scalar_metrics)
from repro_torch.tree import tree_leaves

Tree = Any


def stream_grads(learner, carry: Tree, xs: torch.Tensor, ys: torch.Tensor):
    """Drive the learner over a [k]-step window and read out the gradient.

    Returns (carry, loss, grads, stats) with every stat stacked over the
    window — the online code path's gradient, without the optimizer.  On a
    sharded carry loss, grads and stats are the whole batch's on every
    rank (`read_window`: in the gradient's own collectives)."""
    per_step = []
    for t in range(xs.shape[0]):
        carry, out = learner.step(carry, xs[t], ys[t])
        per_step.append(out.stats)
    stats = {k: torch.stack([s[k] for s in per_step]) for k in per_step[0]}
    loss, grads, stats = learner.read_window(carry, stats)
    return carry, loss, grads, stats


def online_update_chunk(learner, opt, carry: Tree, opt_state: Tree,
                        xs: torch.Tensor, ys: torch.Tensor, upd: int,
                        pack: MetricPack | None = None):
    """One online update: step through the window, update params
    mid-stream, reset the accumulators.  Returns (carry, opt_state,
    metrics) with loss / alpha / beta / overflow as device scalars.

    With `pack` (a `repro_torch.obs.MetricPack`) the metrics are ONE packed
    ``[F]`` float32 tensor under ``metrics["packed"]`` — every telemetry
    scalar in a single device->host readback.  The pack fields only reduce
    values the chunk already computed, so the instrumented chunk's carry /
    opt_state are bit-identical to pack=None (tests/test_torch_obs.py)."""
    carry, loss, grads, stats = stream_grads(learner, carry, xs, ys)
    params, opt_state = opt.update(grads, opt_state,
                                   learner.params_of(carry), upd)
    carry = learner.reset_grads(carry, params)
    if pack is not None:
        packed = pack.pack({"loss": loss, "grads": grads, "stats": stats,
                            "carry": carry})
        return carry, opt_state, {"packed": packed}
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

    rewire_schedule (`repro_torch.sparsity.RewireSchedule`): prune-and-
    regrow events at update boundaries through `learner.rewire` (the
    learner must be built with ``LearnerSpec(rewirable=True)``, the
    optimizer by `masked_dynamic`).  Event e's key is
    `RewireSchedule.event_key(cfg.seed, e)`; the masks live in the carry
    and the event counter in the checkpoint, so a restarted worker replays
    the identical masks.

    guard (`runtime.guard.GuardConfig`): health checks on every window, a
    known-good snapshot ring, rollback and replay under an escalating
    degradation policy.  fault_plan (`runtime.guard.FaultPlan`):
    deterministic fault injection.

    shardings: an optional tree of target shardings
    (`models.module.NamedSharding`) over `_ckpt_tree()` for elastic
    re-mesh resume: `try_resume` places every restored tensor leaf by it,
    on whatever mesh it names (a None entry leaves its leaf on the
    device, as without shardings).

    telemetry (`repro_torch.obs.Telemetry`, default the null form): the
    registry every count of the result comes from; when active, the
    packed window metrics, the `window` / `rewire` / `ckpt_write` spans
    and the events of `--metrics-dir`.

    Learner state outside the carry depends on the masks only: the gate
    segments of compact_fused (whose masks never change) and, on the other
    backends, the column layout, column and J masks and K2's block masks.
    A rewirable learner re-derives the latter from the carry's masks
    whenever it is handed a carry it has not derived them from (after an
    event, a resume or a rollback); a restarted trainer built on the same
    learner and masks rebuilds the rest as it was.
    """

    def __init__(self, cfg: OnlineTrainerConfig, learner, opt, params: Tree,
                 masks: Tree | None, stream: Callable[[int], tuple], *,
                 device: torch.device | str, rewire_schedule=None,
                 guard=None, fault_plan=None, shardings: Tree | None = None,
                 telemetry=None):
        self.cfg = cfg
        self.learner = learner
        self.opt = opt
        # never None past this line: the null form keeps a live registry
        # (every report sources from it) but writes no files; the pack runs
        # in the chunk only when the exporters are on, so the default path
        # stays the bare chunk
        self.obs = telemetry if telemetry is not None else Telemetry.null()
        self._pack = MetricPack.default() if self.obs.active else None
        self._last_packed: dict | None = None
        self._fault_plan = fault_plan
        if fault_plan is not None:
            stream = fault_plan.wrap_stream(stream)
        self.stream = stream
        self.shardings = shardings      # target placements over _ckpt_tree()
        self.device = torch.device(device)
        x0, y0 = stream(0)
        tt = cfg.t_total if cfg.t_total is not None else float(cfg.update_every)
        self.carry = learner.init(params, masks,
                                  (self._to(x0), self._to(y0)), t_total=tt)
        self.opt_state = opt.init(params)
        if rewire_schedule is not None:
            # fail at construction, not at the first event deep into a run
            if "rw" not in self.carry:
                raise ValueError(
                    "rewire_schedule requires a rewirable learner — "
                    "construct it with LearnerSpec(rewirable=True)")
            if not (isinstance(self.opt_state, dict)
                    and "mask" in self.opt_state):
                # a closure-masked optimizer would keep stale moments at
                # pruned positions and pin grown weights at 0
                raise ValueError(
                    "rewire_schedule requires a masked_dynamic optimizer "
                    "(the mask must live in the optimizer state so rewire "
                    "events can swap it) — see "
                    "repro_torch.optim.optimizers.masked_dynamic")
        self.step = 0                     # stream position
        self.update = 0                   # optimizer updates applied
        self.rewire_schedule = rewire_schedule
        self.rewire_events = 0            # events fired (checkpointed)
        # the JAX package's RNG key data for `seed` ([0, seed]).  It is
        # checkpointed so that the leaf set is the JAX package's, and
        # carried unchanged: the JAX package folds it every update but
        # nothing in either package consumes it, so it is never folded here
        self.key = np.array([0, cfg.seed], dtype=np.uint32)
        write_fault = (fault_plan.ckpt_write_fault
                       if fault_plan is not None
                       and fault_plan.fail_ckpt_writes > 0 else None)
        self.ckpt = (CheckpointManager(
            cfg.ckpt_dir or default_ckpt_dir("repro_torch_online_ckpt"),
            keep=cfg.keep,
            retries=(guard.ckpt_retries if guard is not None else 0),
            write_fault=write_fault) if cfg.ckpt_every > 0 else None)
        self.metrics: list[dict] = []     # every log_every-th window
        self.windows: list[dict] = []     # every window: metrics + wall ms
        self._failed_once = False
        self._dt_ema: float | None = None
        self.guard = None
        if guard is not None:
            from repro_torch.runtime.guard import StreamGuard
            self.guard = StreamGuard(guard, telemetry=self.obs)

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

    @property
    def stragglers(self) -> int:
        """Straggler windows so far (registry-backed)."""
        return int(self.obs.registry.counter("stragglers_total").value)

    def save(self):
        if self.ckpt is not None:
            with self.obs.span("ckpt_write", step=self.step):
                self.ckpt.save(self.update, self._ckpt_tree(),
                               extra={"step": self.step})
            self.obs.registry.counter("ckpt_writes_total").inc()
            self.obs.emit("ckpt_write", step=self.step, update=self.update)

    def try_resume(self) -> bool:
        if self.ckpt is None or self.ckpt.latest_step() < 0:
            return False
        # elastic re-mesh: the target shardings (possibly for another mesh
        # than the checkpoint's writer ran on) are the caller's, never read
        # from disk
        tree, upd = self.ckpt.restore(self._ckpt_tree(), self.shardings)
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

    def _restore_snapshot(self, snap):
        """Roll back to a StreamGuard ring snapshot, with tensors of its
        own (the ring keeps its copy for a later rollback)."""
        from repro_torch.runtime.guard import _own
        tree = _own(snap.tree, device=self.device)
        self.carry, self.opt_state = tree["carry"], tree["opt"]
        self.step = snap.step
        self.update = snap.update
        self.rewire_events = snap.rewire_events
        self.key = tree["key"]

    # -- dynamic sparsity ---------------------------------------------------

    def _maybe_rewire(self) -> dict:
        """Fire a prune-and-regrow event if the schedule says so.  Returns
        the metric entries of the log (empty when no event fired)."""
        sch = self.rewire_schedule
        if sch is None or not sch.fires(self.update):
            return {}
        from repro_torch.optim.optimizers import set_opt_mask
        t0 = time.perf_counter()
        ev = self.rewire_events
        with self.obs.span("rewire", event=ev):
            self.carry = self.learner.rewire(
                self.carry, sch.event_key(self.cfg.seed, ev),
                frac=sch.fraction(ev), method=sch.method, block=sch.block)
            self.opt_state = set_opt_mask(
                self.opt_state, self.learner.opt_mask_of(self.carry))
        self.rewire_events = ev + 1
        fp = self.carry_nbytes()
        ms = round((time.perf_counter() - t0) * 1e3, 2)
        reg = self.obs.registry
        reg.gauge("rewire_events").set(self.rewire_events)
        reg.gauge("carry_live_bytes").set(fp["live"])
        reg.gauge("carry_col_density").set(fp["col_density"])
        self.obs.emit("rewire", event=ev, frac=sch.fraction(ev), ms=ms,
                      carry_live_bytes=fp["live"],
                      col_density=fp["col_density"])
        return {"rewire_event": ev, "rewire_frac": round(sch.fraction(ev), 5),
                "rewire_ms": ms, "carry_live_bytes": fp["live"]}

    def carry_nbytes(self) -> dict:
        """{'alloc', 'live', 'col_density'}: the carry's allocated bytes and
        its LIVE footprint, each influence buffer priced at its live column
        count (`costs.carry_footprint`), so that after rewire events it
        reports the live width, not the allocation.  Stacked buffers are
        priced per layer: layer l's buffer holds zeros in the columns of
        layers j > l, so its live width is the <= l share of the shared
        compact axis."""
        from repro_torch.core.costs import carry_footprint
        c = self.carry
        total = carry_nbytes(c)
        out = {"alloc": total, "live": total, "col_density": 1.0}
        rw = c.get("rw")
        if rw is None:
            return out
        if "cl" in rw:
            live_v, layer_v = rw["cl"]["live"], rw["cl"]["layer"]
            n_cols = live_v.shape[-1]
            n_live = int(live_v.sum())
            layer_live = lambda l: int((live_v * (layer_v <= l)).sum())
        elif "colm" in rw:
            n_cols, n_live = rw["colm"].shape[-1], int(rw["colm"].sum())
            layer_live = lambda l: n_live
        elif "colms" in rw:
            colms = rw["colms"]
            n_cols, n_live = colms[-1].shape[-1], int(colms[-1].sum())
            layer_live = lambda l: int(colms[l].sum())
        else:
            return out
        bufs = []                                    # (buffer, layer-or-None)
        # the scaled learner nests its buffers under carry["state"]
        for holder in (c, c.get("state") or {}):
            for k in ("vals", "M"):
                src = holder.get(k)
                if src is None:
                    continue
                bufs += ([(b, l) for l, b in enumerate(src)]
                         if isinstance(src, tuple) else [(src, None)])
        live_total = total
        for b, l in bufs:
            if isinstance(b, torch.Tensor) and b.shape[-1] == n_cols:
                rows = b.numel() // n_cols
                nl = n_live if l is None else layer_live(l)
                fp = carry_footprint(1, rows, n_cols, nl)
                live_total += fp["live_bytes"] - fp["alloc_bytes"]
        out["live"] = live_total
        out["col_density"] = n_live / n_cols
        return out

    def row_stats(self) -> dict | None:
        """Per-example active-row stats of a compact influence carry, or
        None off the compact backends: K_b = live rows of example b;
        'ragged_utilization' = Sigma_b K_b / (B * K_max), pooled over the
        layers of a stacked carry as in the JAX package, whose per-layer
        stats follow under 'layers'.  Also reports the carry dtype.  The
        scaled learner's buffers are read under carry["state"]; a sharded
        carry reports its whole batch, as one device would."""
        from repro_torch.sharding import full_value
        holder = self.carry.get("state") or self.carry
        idx, vals = holder.get("idx"), holder.get("vals")
        if idx is None:
            return None
        stacked = isinstance(idx, tuple)
        # a sharded carry's rows gathered (one all_gather a layer's idx
        # over the batch axes): the whole batch's stats on every rank
        idxs = tuple(full_value(i) for i in (idx if stacked else (idx,)))
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
            self.obs.registry.counter("stragglers_total").inc()
        self._dt_ema = 0.9 * self._dt_ema + 0.1 * dt

    def _execute_window(self, start: int, k: int):
        """Execute one update window under the guard's pending degradation,
        if any.  Returns (ok, host metrics, guard record); ok=False means
        the window faulted and the trainer was rolled back — the loop then
        re-executes it (a deterministic replay) one rung up the ladder.
        Every path reads the window's scalars back once: the packed vector
        when telemetry is on (it serves the guard too), else the metrics
        stacked by `scalar_metrics`."""
        from repro_torch.runtime import guard as G
        g = self.guard
        self._last_packed = None
        action = None if g is None else g.pending_action(start)
        if action == "quarantine":
            # persistent data fault: drop the window's inputs; carry,
            # params and optimizer are untouched, the stream skips past it
            g.note_quarantine(start, k, self.update)
            return True, {}, {"guard_action": action}
        xs, ys = self._gather(start, k)
        if g is None:
            self.carry, self.opt_state, m = online_update_chunk(
                self.learner, self.opt, self.carry, self.opt_state, xs, ys,
                self.update, pack=self._pack)
            # THE window readback: blocks until the device finished it
            if self._pack is not None:
                self._last_packed = self._pack.unpack(m["packed"])
                return True, _legacy_metrics(self._last_packed), {}
            return True, scalar_metrics(m), {}
        if action == "skip_update":
            # the degraded advance keeps its own packed verdict
            carry, m = G.advance_chunk(self.learner, self.carry, xs, ys)
            opt_state = self.opt_state
        else:
            # 'clip' degrades; clip=+inf is exactly factor 1.0, so the
            # healthy path stays bit-identical to the unguarded chunk
            clip = g.cfg.clip_norm if action == "clip" else math.inf
            carry, opt_state, m = G.guarded_update_chunk(
                self.learner, self.opt, self.carry, self.opt_state, xs, ys,
                self.update, clip, pack=self._pack)
        if "packed" in m:
            # one readback serves guard AND telemetry: the guard gets the
            # unpacked verdict as host floats
            pk = self._pack.unpack(m["packed"])
            m = {"health": pk["health"], "loss": pk["loss"],
                 "overflow": pk["overflow"]}
        else:
            pk = None
            m.pop("verdict")
            m = scalar_metrics(m)
        fault = g.check(m, self.update)
        if fault is not None:
            g.on_fault(self, fault)
            return False, None, None
        self.carry, self.opt_state = carry, opt_state
        if pk is not None:
            self._last_packed = pk
            m = _legacy_metrics(pk)
        else:
            m.pop("health")
        return True, m, ({"guard_action": action} if action else {})

    def _maybe_crash(self):
        """The injected failures: `fail_at_update` and the fault plan's
        crash.  Each lands the pending checkpoint write first, so that the
        restart resumes from it and replays the same windows on every run;
        a real crash can lose that write, and valid_steps covers that."""
        try:
            if self.update == self.cfg.fail_at_update \
                    and not self._failed_once:
                self._failed_once = True
                raise InjectedFailure(
                    f"injected failure at update {self.update} "
                    f"(stream step {self.step})")
            if self._fault_plan is not None:
                self._fault_plan.maybe_crash(self.update)
        except InjectedFailure:
            if self.ckpt is not None:
                self.ckpt.wait()
            raise

    def run(self) -> dict:
        cfg = self.cfg
        if self.guard is not None and not self.guard.ring:
            self.guard.push(self)         # initial known-good restore point
        while self.step < cfg.total_steps:
            self._maybe_crash()
            k = min(cfg.update_every, cfg.total_steps - self.step)
            start = self.step
            t0 = time.perf_counter()
            with self.obs.span("window", update=self.update, step=start):
                ok, m, guard_rec = self._execute_window(start, k)
            if not ok:
                continue                  # rolled back; the window replays
            dt = time.perf_counter() - t0
            self._watch_straggler(dt)
            self.step = start + k
            self.update += 1
            self.windows.append({"update": self.update, "ms": dt * 1e3, **m,
                                 **guard_rec})
            self.obs.record_window(self.update, self.step, dt * 1e3,
                                   packed=self._last_packed, **guard_rec)
            rewire_rec = self._maybe_rewire()
            if self.guard is not None:
                # commit AFTER rewire, so that snapshots carry the
                # post-event masks and the matching event counter
                self.guard.commit(self, start)
            if self._fault_plan is not None:
                self._fault_plan.maybe_corrupt(self)
            if self.ckpt is not None and self.update % cfg.ckpt_every == 0:
                self.save()
            if (rewire_rec or guard_rec or self.update % cfg.log_every == 0
                    or self.step >= cfg.total_steps):
                rec = {"update": self.update, "step": self.step,
                       "dt_s": round(dt, 4), **rewire_rec, **guard_rec, **m}
                self.metrics.append(rec)
                if cfg.metrics_path:
                    with open(cfg.metrics_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
        self.save()
        if self.ckpt is not None:
            self.ckpt.wait()
        # land the run-level numbers on the registry, then source the
        # result dict FROM it: the result, the Prometheus text and the
        # manifest cannot disagree
        fp = self.carry_nbytes()
        reg = self.obs.registry
        reg.gauge("final_step").set(self.step)
        reg.gauge("updates").set(self.update)
        reg.gauge("rewire_events").set(self.rewire_events)
        reg.gauge("carry_alloc_bytes").set(fp["alloc"])
        reg.gauge("carry_live_bytes").set(fp["live"])
        reg.gauge("carry_col_density").set(fp["col_density"])
        out = {"final_step": int(reg.gauge("final_step").value),
               "updates": int(reg.gauge("updates").value),
               "metrics": self.metrics,
               "rewire_events": int(reg.gauge("rewire_events").value),
               "carry_bytes": int(reg.gauge("carry_alloc_bytes").value),
               "carry_live_bytes": int(reg.gauge("carry_live_bytes").value),
               "stragglers": self.stragglers, "windows": self.windows}
        rs = self.row_stats()
        if rs is not None:
            out["row_stats"] = rs
        if self.guard is not None:
            out["guard"] = self.guard.report()
        return out


def _legacy_metrics(pk: dict) -> dict:
    """Unpacked MetricPack dict -> the chunk-metrics keys the log records
    always carried (loss / alpha / beta / overflow).  NaN fields are the
    pack's 'not applicable to this engine' marker — dropped, matching the
    bare chunk's key presence."""
    m = {"loss": pk["loss"]}
    for src, dst in (("act_sparsity", "alpha"), ("bwd_sparsity", "beta"),
                     ("overflow", "overflow")):
        v = pk.get(src)
        if v is not None and not math.isnan(v):
            m[dst] = v
    return m


def carry_nbytes(carry: Tree) -> int:
    """Total bytes held by the learner carry — the O(1)-in-stream-length
    memory claim, as a number."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(carry)
                   if isinstance(t, torch.Tensor)))
