"""StreamGuard: fault-injected resilience for unbounded online RTRL, in
PyTorch.

Counterpart of `repro.runtime.guard`.  The RTRL influence carry persists
forever — unlike BPTT, nothing flushes it at a sequence boundary — so one
non-finite step (a NaN input, a loss-scale overflow, a corrupted buffer)
poisons every later gradient of the stream.  The guard lets unbounded
online training survive such faults without giving up exactness:

1. **Detection**, in the guarded update chunk: a finite-check bitmask over
   (loss, grads, the whole learner carry), read back with the window's
   other scalars in one readback; plus two host detectors on scalars the
   trainer reads anyway — an overflow-streak counter on the compact
   engines' ``overflow`` and a loss-spike EMA z-score.
2. **Rollback and replay**: a ring of the last R known-good snapshots of
   the tree the trainer checkpoints ({carry, optimizer state, RNG key
   data} plus stream position and rewire-event counter).  On a fault the
   trainer rolls back and replays the window — the step-keyed stream makes
   the replay exact — one rung further up the degradation policy each
   time:

       replay       re-run as is (heals a transient fault, e.g. a
                    corrupted carry: the snapshot restores good state)
       clip         re-run with global-norm gradient clipping
       skip_update  advance the carry through the window WITHOUT the
                    optimizer update
       quarantine   skip the window's inputs (heals a persistent data
                    fault: NaN inputs replay as NaN forever)

   A window that exhausts the policy raises :class:`StreamFault`.  The
   masks live in the carry and the event counter in the snapshot, so a
   rollback across a rewire boundary replays the identical masks.
3. **Fault injection** (:class:`FaultPlan`): NaN input windows, carry
   corruption, checkpoint-write failures and crashes.

Snapshots own their tensors: `push` clones every tensor leaf, and a
rollback hands the trainer clones of the snapshot's, so no later write —
in place or not — can reach a snapshot (torch tensors are mutable, unlike
the JAX package's arrays, which its ring holds by reference).
`corrupt_carry` builds a new tensor as well.

A sharded carry (`ScaledLearner.place`): the verdict is the group's (each
rank checks its own shards, then one all_reduce of the three fault bits
over the whole mesh), so a fault in one rank's rows rolls every rank back
to the same snapshot; a snapshot keeps each rank's local shards as they
are, ungathered.

Telemetry (`repro_torch.obs`): with a `MetricPack` the guarded chunk folds
its verdict into the window's packed vector, so one readback serves the
guard and the exporters; the guard's counts live on the telemetry
registry (`guard_*_total`) and every fault, rollback, recovery and
quarantine is an event.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import math
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.collectives import all_reduce
from repro_torch.obs import Telemetry
from repro_torch.obs.metricpack import global_norm
from repro_torch.obs.trace import span
from repro_torch.runtime.online import stream_grads
from repro_torch.runtime.trainer import InjectedFailure
from repro_torch.tree import (tree_flatten_with_path, tree_leaves, tree_map,
                              tree_map_with_path)

Tree = Any

# health bitmask (computed on the device, read back with the window)
# (bit i is source i of health_bits: loss, grads, carry)
HEALTH_LOSS = 1        # window loss is non-finite
HEALTH_GRADS = 2       # some gradient leaf is non-finite
HEALTH_CARRY = 4       # some carry leaf (influence/activity/params) is non-finite

ACTIONS = ("replay", "clip", "skip_update", "quarantine")

POLICIES = {
    "full": ("replay", "clip", "skip_update", "quarantine"),
    "strict": ("replay", "clip"),          # never drop data; escalate instead
    "replay-only": ("replay",),
}


class StreamFault(RuntimeError):
    """A fault the guard's degradation policy could not absorb — surfaced
    to the supervisor (not retryable: restarting replays the same stream,
    so a data fault that exhausted the policy once would again)."""


def resolve_policy(spec) -> tuple:
    """A policy preset name ('full' | 'strict' | 'replay-only') or a
    comma-separated action list -> validated action tuple."""
    if isinstance(spec, (tuple, list)):
        actions = tuple(spec)
    elif spec in POLICIES:
        actions = POLICIES[spec]
    else:
        actions = tuple(a.strip() for a in str(spec).split(",") if a.strip())
    bad = [a for a in actions if a not in ACTIONS]
    if bad or not actions:
        raise ValueError(f"unknown guard action(s) {bad}; choose from "
                         f"{ACTIONS} or a preset {tuple(POLICIES)}")
    return actions


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """StreamGuard knobs (the JAX package's).

    ring            known-good snapshots retained for rollback
    snapshot_every  updates between ring pushes (1 = every update)
    policy          escalation ladder, tried in order on repeated faults at
                    the same window
    clip_norm       global gradient-norm ceiling of the 'clip' action
    spike_z         loss-spike threshold in EMA z-score units
    spike_warmup    healthy updates before the spike detector arms
    spike_ema       EMA decay of the loss mean/variance trackers
    overflow_streak consecutive overflowing updates that count as a fault
                    (0 disables)
    host_offload    copy ring snapshots to host memory on a background
                    thread instead of keeping them on the device
    ckpt_retries    write retries the trainer's CheckpointManager gets
    """
    ring: int = 4
    snapshot_every: int = 1
    policy: tuple = POLICIES["full"]
    clip_norm: float = 1.0
    spike_z: float = 10.0
    spike_warmup: int = 20
    spike_ema: float = 0.9
    overflow_streak: int = 3
    host_offload: bool = False
    ckpt_retries: int = 2

    def __post_init__(self):
        object.__setattr__(self, "policy", resolve_policy(self.policy))
        if self.ring < 1:
            raise ValueError("ring must be >= 1")


# ---------------------------------------------------------------------------
# Health check + guarded update chunks
# ---------------------------------------------------------------------------

def _floating(tree) -> list:
    """The non-empty floating leaves of `tree` (an empty leaf holds no
    non-finite value; integer leaves never count)."""
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)
            and x.is_floating_point() and x.numel()]


def _amax_each(tensors: list) -> list:
    """max |x| of each tensor, a 0-d tensor each: one multi-tensor
    reduction a dtype (`torch._foreach_norm` at order inf, the foreach
    kernels where the device has them), each tensor read where it lies."""
    out = [None] * len(tensors)
    by_dtype: dict = {}
    for i, x in enumerate(tensors):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        amax = torch._foreach_norm([tensors[i] for i in idx], math.inf)
        for i, a in zip(idx, amax):
            out[i] = a
    return out


def health_bits(loss, grads, carry) -> torch.Tensor:
    """The int32 fault bitmask (0 = healthy), on the loss's device.

    A max |x| is non-finite iff its tensor holds a NaN or an inf, so the
    check is one multi-tensor max |x| over the loss and every floating leaf
    of both trees, with no copy of either.  The three sources (loss, grads,
    carry: bits 0, 1, 2) are padded to one length with repeats of their
    smallest member, so their three verdicts come out of one [3, m]
    reduction: about ten device ops, whatever the number of leaves.

    A sharded leaf (a DTensor) is checked on this rank's shard, and the
    three bits are then the group's: one all_reduce (max) over its mesh."""
    from repro_torch.sharding import is_dtensor
    loss = torch.as_tensor(loss)
    mesh = None

    def local(xs):
        nonlocal mesh
        for i, x in enumerate(xs):
            if is_dtensor(x):
                mesh, xs[i] = x.device_mesh, x.to_local()
        return xs
    sources = [[loss], local(_floating(grads)), local(_floating(carry))]
    if not all(sources):                    # advance_chunk has no grads
        zero = loss.new_zeros(())
        sources = [s or [zero] for s in sources]
    m = max(len(s) for s in sources)
    flat = [x for s in sources
            for x in s + [min(s, key=torch.numel)] * (m - len(s))]
    amax = torch.stack(_amax_each(flat)).view(3, m).amax(dim=1)
    bad = ~(amax < math.inf)                # NaN < inf is False as well
    if mesh is not None:
        bad = all_reduce(bad.float(), mesh, tuple(mesh.mesh_dim_names),
                         op="max") > 0
    bit = torch.arange(3, dtype=torch.int32, device=loss.device)
    return (bad.int() << bit).sum(dtype=torch.int32)


def describe_health(bits: int) -> str:
    names = [n for b, n in ((HEALTH_LOSS, "loss"), (HEALTH_GRADS, "grads"),
                            (HEALTH_CARRY, "carry")) if bits & b]
    return "+".join(names) or "ok"


def guarded_update_chunk(learner, opt, carry: Tree, opt_state: Tree,
                         xs: torch.Tensor, ys: torch.Tensor, upd: int,
                         clip: float, pack=None):
    """`online_update_chunk` with the guard woven in: global-norm gradient
    clipping (clip = +inf gives the factor exactly 1.0, so an unfaulted
    guarded run is bit-identical to the unguarded chunk) and the health
    bitmask in ``metrics["health"]`` (and in the packed
    ``metrics["verdict"]``).

    With `pack` (a `repro_torch.obs.MetricPack`) the verdict folds into the
    telemetry vector instead: metrics is ``{"packed": [F]}``, carrying
    health / loss / overflow beside every other telemetry scalar, so one
    readback serves the guard AND the exporters."""
    carry, loss, grads, stats = stream_grads(learner, carry, xs, ys)
    with span("engine.update"):
        gn = global_norm(grads)
        factor = torch.minimum(torch.ones_like(gn), clip / (gn + 1e-12))
        grads = tree_map(lambda g: g * factor, grads)
        params, opt_state = opt.update(grads, opt_state,
                                       learner.params_of(carry), upd)
        carry = learner.reset_grads(carry, params)
    health = health_bits(loss, grads, carry)
    if pack is not None:
        packed = pack.pack({"loss": loss, "grads": grads, "stats": stats,
                            "carry": carry, "grad_norm": gn,
                            "clip_factor": factor, "health": health})
        return carry, opt_state, {"packed": packed}
    metrics = {"loss": loss, "grad_norm": gn, "health": health}
    for k in ("alpha", "beta"):
        if k in stats:
            metrics[k] = stats[k].mean()
    if "overflow" in stats:
        metrics["overflow"] = stats["overflow"].max()
    metrics["verdict"] = _pack_verdict(metrics)
    return carry, opt_state, metrics


def _pack_verdict(metrics: dict) -> torch.Tensor:
    """[health_bits, loss, overflow] packed into one float32 tensor, so a
    detector handed device metrics reads one buffer (the bitmask is a
    small int — exact in float32)."""
    loss = metrics["loss"]
    ov = metrics.get("overflow")
    ov = torch.zeros((), device=loss.device) if ov is None else ov
    return torch.stack([metrics["health"].float(), loss.float(), ov.float()])


def advance_chunk(learner, carry: Tree, xs: torch.Tensor, ys: torch.Tensor):
    """The 'skip_update' degradation: drive the learner through the window
    and drop the accumulated gradient WITHOUT touching params or the
    optimizer — the stream advances, the influence stays exact."""
    per_step = []
    for t in range(xs.shape[0]):
        carry, out = learner.step(carry, xs[t], ys[t])
        per_step.append(out.stats)
    with span("engine.read_window"):
        stats = {k: torch.stack([s[k] for s in per_step])
                 for k in per_step[0]}
        loss, _, stats = learner.read_window(carry, stats, grads=False)
    carry = learner.reset_grads(carry, None)
    metrics = {"loss": loss, "health": health_bits(loss, (), carry)}
    if "overflow" in stats:
        metrics["overflow"] = stats["overflow"].max()
    metrics["verdict"] = _pack_verdict(metrics)
    return carry, metrics


# ---------------------------------------------------------------------------
# The guard
# ---------------------------------------------------------------------------

def _own(tree: Tree, device=None) -> Tree:
    """A copy of `tree` that shares no storage with it: tensors cloned (or
    copied to `device`), numpy values copied.  A DTensor's copy is its
    local shard's, wrapped with the same mesh and placements (no
    collective: each rank keeps its own shards)."""
    from torch.distributed.tensor import DTensor

    def own(x):
        if isinstance(x, DTensor):
            return DTensor.from_local(own(x.to_local()), x.device_mesh,
                                      x.placements, run_check=False,
                                      shape=x.shape, stride=x.stride())
        if isinstance(x, torch.Tensor):
            return x.clone() if device is None else x.to(device, copy=True)
        return copy.copy(x)
    return tree_map(own, tree)


@dataclasses.dataclass
class Snapshot:
    """One known-good restore point.  Its tree owns its tensors (cloned at
    push); with host offload the copy to host memory runs on a background
    thread, joined (`_ready`) before the snapshot is read."""
    tree: Tree
    step: int
    update: int
    rewire_events: int
    _thread: threading.Thread | None = None


class StreamGuard:
    """Detector state + snapshot ring + escalation bookkeeping.  One per
    OnlineTrainer run; host side."""

    def __init__(self, cfg: GuardConfig, telemetry=None):
        self.cfg = cfg
        # the counts live on the telemetry registry (the null form keeps a
        # registry too); the detail lists stay for report()['fault_log']
        self.obs = telemetry if telemetry is not None else Telemetry.null()
        self.ring: collections.deque = collections.deque(maxlen=cfg.ring)
        self._mu: float | None = None      # loss EMA mean
        self._var = 0.0                    # loss EMA variance
        self._n_healthy = 0
        self._ov_streak = 0
        self._fault_step: int | None = None   # window start being recovered
        self._attempts = 0
        self.faults: list[dict] = []
        self.recoveries: list[dict] = []
        self.quarantined: list[dict] = []

    @property
    def rollbacks(self) -> int:
        return int(self.obs.registry.counter("guard_rollbacks_total").value)

    # -- detection ----------------------------------------------------------

    def check(self, metrics: dict, update: int) -> str | None:
        """Host verdict on one window's metrics: a fault reason, or None
        (healthy; the detector EMAs learn only then).  Takes host floats,
        or device metrics with a packed "verdict" (one readback)."""
        if "verdict" in metrics:
            health, loss, ov = torch.as_tensor(metrics["verdict"]).tolist()
            vals = {"health": health, "loss": loss, "overflow": ov}
        else:
            vals = {k: float(metrics[k]) for k in ("health", "loss",
                                                    "overflow")
                    if k in metrics}
        bits = int(vals.get("health", 0))
        if bits:
            return f"nonfinite:{describe_health(bits)}"
        if vals.get("overflow", 0.0) > 0:
            self._ov_streak += 1
            if (self.cfg.overflow_streak > 0
                    and self._ov_streak >= self.cfg.overflow_streak):
                self._ov_streak = 0
                return (f"overflow_streak:{self.cfg.overflow_streak}"
                        f"@update{update}")
        else:
            self._ov_streak = 0
        loss = vals.get("loss")
        if loss is not None:
            spike = self._spike(loss)
            if spike is not None:
                return spike
            self._ema_update(loss)
        return None

    def _spike(self, loss: float) -> str | None:
        if self._mu is None or self._n_healthy < self.cfg.spike_warmup:
            return None
        sigma = max(math.sqrt(max(self._var, 0.0)),
                    1e-3 * abs(self._mu) + 1e-8)
        z = (loss - self._mu) / sigma
        if z > self.cfg.spike_z:
            return f"loss_spike:z={z:.1f}"
        return None

    def _ema_update(self, loss: float):
        a = self.cfg.spike_ema
        if self._mu is None:
            self._mu, self._var = loss, 0.0
        else:
            d = loss - self._mu
            self._mu += (1.0 - a) * d
            self._var = a * (self._var + (1.0 - a) * d * d)
        self._n_healthy += 1

    # -- escalation ---------------------------------------------------------

    def pending_action(self, window_start: int) -> str | None:
        """The degradation to apply when (re)executing this window: None
        until the window has faulted, then the policy ladder, one rung per
        fault ('replay' is a plain re-execution)."""
        if self._fault_step != window_start or self._attempts == 0:
            return None
        return self.cfg.policy[self._attempts - 1]

    def on_fault(self, trainer, reason: str):
        """Record the fault, escalate, and roll the trainer back to the
        newest known-good snapshot.  Raises StreamFault once the policy is
        exhausted for this window."""
        if self._fault_step != trainer.step:
            self._fault_step, self._attempts = trainer.step, 0
        self._attempts += 1
        self.faults.append({"reason": reason, "step": trainer.step,
                            "update": trainer.update,
                            "attempt": self._attempts})
        self.obs.registry.counter("guard_faults_total").inc()
        self.obs.emit("fault", reason=reason, step=trainer.step,
                      update=trainer.update, attempt=self._attempts)
        if self._attempts > len(self.cfg.policy):
            raise StreamFault(
                f"guard policy {self.cfg.policy} exhausted at stream step "
                f"{trainer.step} (update {trainer.update}): {reason}")
        self.rollback(trainer)

    def rollback(self, trainer):
        if not self.ring:
            raise StreamFault("fault before any known-good snapshot "
                              f"existed: {self.faults[-1]['reason']}")
        snap = self._ready(self.ring[-1])
        with self.obs.span("rollback_replay", to_step=snap.step):
            trainer._restore_snapshot(snap)
        self.obs.registry.counter("guard_rollbacks_total").inc()
        self.obs.emit("rollback", to_step=snap.step, to_update=snap.update)

    def commit(self, trainer, window_start: int):
        """A window executed healthily: close any recovery in flight for it
        and push a ring snapshot on the cadence (after rewire events fire,
        so snapshots carry the post-event masks and event counter)."""
        if self._fault_step == window_start:
            rec = {"step": window_start,
                   "action": self.cfg.policy[self._attempts - 1],
                   "attempts": self._attempts}
            self.recoveries.append(rec)
            self.obs.registry.counter("guard_recoveries_total").inc()
            self.obs.emit("recovery", **rec)
            self._fault_step, self._attempts = None, 0
        if (not self.ring
                or trainer.update % max(1, self.cfg.snapshot_every) == 0):
            self.push(trainer)

    # -- snapshot ring ------------------------------------------------------

    def push(self, trainer):
        self.push_tree(trainer._ckpt_tree(), trainer.step, trainer.update,
                       trainer.rewire_events)

    def push_tree(self, tree: Tree, step: int, update: int,
                  rewire_events: int = 0):
        snap = Snapshot(_own(tree), step, update, rewire_events)
        if self.cfg.host_offload:
            # the copy to host memory off the hot path: the loop pays a
            # clone and a thread handoff; _ready joins before a rollback
            def offload():
                snap.tree = _own(snap.tree, device="cpu")

            snap._thread = threading.Thread(target=offload, daemon=True)
            snap._thread.start()
        self.ring.append(snap)

    @staticmethod
    def _ready(snap: Snapshot) -> Snapshot:
        if snap._thread is not None:
            snap._thread.join()
            snap._thread = None
        return snap

    def note_quarantine(self, start: int, length: int, update: int):
        self.quarantined.append({"start": start, "len": length,
                                 "update": update})
        self.obs.registry.counter("guard_quarantined_total").inc()
        self.obs.emit("quarantine", start=start, len=length, update=update)

    def report(self) -> dict:
        """The JAX package's report keys; the counts come from the
        telemetry registry, so report, Prometheus text and manifest
        agree."""
        reg = self.obs.registry
        return {"faults": int(reg.counter("guard_faults_total").value),
                "rollbacks": int(reg.counter("guard_rollbacks_total").value),
                "recoveries": self.recoveries,
                "quarantined": self.quarantined, "fault_log": self.faults}


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault injection for resilience tests and smokes.

    nan_input_at / nan_input_len   stream steps [at, at+len) read NaN inputs
                                   (persistent: a replay re-reads NaN)
    corrupt_carry_at_update        after this update commits, one influence
                                   element becomes NaN (one-shot)
    crash_at_update                raise InjectedFailure before this update
                                   executes (one-shot)
    fail_ckpt_writes               the first N checkpoint write attempts
                                   raise OSError
    """
    nan_input_at: int = -1
    nan_input_len: int = 1
    corrupt_carry_at_update: int = -1
    crash_at_update: int = -1
    fail_ckpt_writes: int = 0

    def __post_init__(self):
        self._corrupted = False
        self._crashed = False
        self._ckpt_attempts = 0

    def wrap_stream(self, stream: Callable[[int], tuple]):
        if self.nan_input_at < 0:
            return stream
        lo, hi = self.nan_input_at, self.nan_input_at + self.nan_input_len

        def wrapped(t: int):
            x, y = stream(t)
            if lo <= t < hi:
                x = np.full_like(np.asarray(x, np.float32), np.nan)
            return x, y

        return wrapped

    def maybe_crash(self, update: int):
        if update == self.crash_at_update and not self._crashed:
            self._crashed = True
            raise InjectedFailure(
                f"fault-plan crash before update {update}")

    def maybe_corrupt(self, trainer):
        if (trainer.update != self.corrupt_carry_at_update
                or self._corrupted):
            return
        self._corrupted = True
        trainer.carry = corrupt_carry(trainer.carry)

    def ckpt_write_fault(self, step: int):
        """CheckpointManager `write_fault` hook: raise for the first N
        write attempts (across steps), then write normally."""
        self._ckpt_attempts += 1
        if self._ckpt_attempts <= self.fail_ckpt_writes:
            raise OSError(
                f"fault-plan checkpoint write failure "
                f"{self._ckpt_attempts}/{self.fail_ckpt_writes} "
                f"(step {step})")


def corrupt_carry(carry: Tree, value: float = math.nan) -> Tree:
    """Poison one element of the carried influence (the cosmic-ray /
    bad-DMA fault): NaN * 0 = NaN, so the poison spreads through every
    later influence contraction.  Returns a new carry whose poisoned
    buffer is a new tensor; no existing tensor is written.  On a sharded
    buffer the element is the whole buffer's first, in the shard of the
    rank that holds it."""
    from repro_torch.sharding import is_dtensor
    new = dict(carry)
    for k in ("vals", "M", "state"):
        if k not in new:
            continue
        for path, leaf in tree_flatten_with_path(new[k]):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                poisoned = _own(leaf)
                local = poisoned.to_local() if is_dtensor(leaf) else poisoned
                if not is_dtensor(leaf) or _holds_first(leaf):
                    local[(0,) * leaf.ndim] = value
                new[k] = tree_map_with_path(
                    lambda p, x: poisoned if p == path else x, new[k])
                return new
    raise ValueError("carry holds no influence buffer to corrupt "
                     f"(keys: {list(carry)})")


def _holds_first(x) -> bool:
    """Whether this rank's shard of DTensor `x` holds its element 0."""
    from torch.distributed.tensor import Shard
    return all(c == 0 for p, c in zip(x.placements,
                                      x.device_mesh.get_coordinate())
               if isinstance(p, Shard))
