"""Multi-tenant stream fleet: S concurrent online-RTRL sessions behind one
vmapped update chunk, in PyTorch.

Counterpart of `repro.runtime.fleet`.  `OnlineTrainer` drives one stream, so
serving S users would cost S dispatches of a small chunk whose wall clock is
per-op overhead, not FLOPs.  :class:`StreamFleet` stacks S independent
sessions — params, optimizer moments, learner carry and stream position
each — along a leading *slot* axis and drives them all through one update
chunk: `fleet_update_chunk`, `torch.func.vmap` of `online_update_chunk`
over the slot axis.  The kernels of the chunk see the slots as examples:
K1 (`compact_fused`) and K2 (`pallas`) fold the slot axis into their batch
axis and launch once a stream step for every slot (`kernels._build.fold`).

Slot-based continuous batching, as in the JAX package:

- the fleet shape (S, window k, per-session batch B) is fixed — sessions
  join and leave mid-flight at different stream positions;
- dead slots are don't-care lanes: vmapped per-slot computation is
  lane-independent (each slot's ops round as they would alone), so a dead
  lane grinding on throwaway state cannot move a live lane's bits.  The
  `live` mask gates the window's packed rows and the host bookkeeping
  only; a join overwrites the slot's buffers and a leave resets them to
  the template, so dead-lane contents are never observed;
- idle sessions evict their full {carry, optimizer state, stream position,
  update count} to the session-keyed checkpoint store
  (`repro_torch.checkpoint.save_session`) and later resume bit for bit.

Memory and sync: the stacked buffers live on the fleet's device, slot
writes are in-place copies into them (a slot read returns tensors of its
own, so a later write cannot reach a state handed out before), and a
window reads back once: the packed [S, 3] rows of live flag, window loss
and compact-capacity overflow ([S, 3 + F] with the `MetricPack` columns
when telemetry is on).

Every session shares one learner (one engine and one set of masks, so the
column layout, K1's gate segments and K2's constant block masks serve every
slot) and one optimizer; sessions differ in parameter values, carry,
optimizer moments, update count and stream position.  On the CPU a fleet
of 1 is bitwise the solo `OnlineTrainer` (tests/test_torch_fleet.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import load_session, save_session
from repro_torch.obs import MetricPack, Telemetry
from repro_torch.runtime.online import carry_nbytes, online_update_chunk
from repro_torch.tree import tree_map

Tree = Any


def fleet_update_chunk(learner, opt, carry: Tree, opt_state: Tree,
                       xs: torch.Tensor, ys: torch.Tensor, upd,
                       live: torch.Tensor, pack: MetricPack | None = None):
    """One update window for every slot at once.

    carry/opt_state: slot-stacked trees (leading axis S).  xs [S, k, B,
    ...], ys [S, k, B], upd the [S] per-slot update counts on the host
    (slots joined at different times; `opt.slot_steps` turns them into the
    update's step argument, adamw's bias corrections), live [S] bool.

    `torch.func.vmap` of `online_update_chunk` over the slot axis.  Every
    lane, live or dead, runs the chunk; dead lanes grind on don't-care
    state (the host feeds them zero inputs) whose outputs are never
    observed.  `live` only gates the metrics: the packed [S, 3] float32 rows
    are [live, loss * live, overflow * live], the window's one readback.
    With `pack` (a `repro_torch.obs.MetricPack`) each row grows to
    [S, 3 + F]: the same three columns, then the slot's telemetry vector.
    Returns (carry, opt_state, packed)."""
    steps = opt.slot_steps(upd, xs.device)
    carry, opt_state, m = torch.func.vmap(
        lambda c, o, x, y, u: online_update_chunk(learner, opt, c, o, x, y,
                                                  u, pack=pack)
    )(carry, opt_state, xs, ys, steps)
    lf = live.float()
    if pack is not None:
        vec = m["packed"]                               # [S, F]
        loss = vec[:, pack.names.index("loss")] * lf
        ov_col = vec[:, pack.names.index("overflow")]
        ov = torch.where(torch.isnan(ov_col), 0.0, ov_col) * lf
        packed = torch.cat([torch.stack([lf, loss, ov], dim=-1), vec],
                           dim=-1)
        return carry, opt_state, packed
    loss = m["loss"].float() * lf
    ov = (m["overflow"].float() * lf if "overflow" in m
          else torch.zeros_like(lf))
    return carry, opt_state, torch.stack([lf, loss, ov], dim=-1)


@dataclasses.dataclass
class FleetConfig:
    slots: int = 8                  # S: fixed fleet width
    update_every: int = 8           # k: stream steps per window/update
    store_dir: str | None = None    # session eviction store (None: no evict)
    t_total: float | None = None    # per-step loss scale (None: update_every)
    seed: int = 0


@dataclasses.dataclass
class _Session:
    sid: str
    stream: Callable[[int], tuple]
    slot: int
    pos: int = 0                    # stream position
    upd: int = 0                    # optimizer updates applied
    loss: float = float("nan")      # last window loss (from the packed row)
    overflow: float = 0.0           # last window compact-capacity overflow


class StreamFleet:
    """S concurrent online-RTRL sessions behind one vmapped update chunk.

    learner/opt/masks are shared by every session (the learner binds one
    masks object at its first init); `params` seeds the slot template and
    is the default init of a joining session.  `example` is one (x_0, y_0)
    batch (numpy) fixing the per-session stream shapes; `device` holds the
    stacked buffers.

    API: `add_session(sid, stream, params=)` claims a free slot, `remove`
    frees it, `evict(sid)` writes the session's full state to the store and
    frees its slot, `resume(sid, stream)` loads it back bit for bit into
    any free slot, `slot_state(sid)` copies one session's (carry,
    opt_state) out, and `step_window()` advances every live session by one
    k-step window.
    """

    def __init__(self, cfg: FleetConfig, learner, opt, params: Tree,
                 masks: Tree | None, example: tuple, *,
                 device: torch.device | str, telemetry=None):
        self.cfg = cfg
        self.learner = learner
        self.opt = opt
        self.masks = masks
        self.device = torch.device(device)
        self.obs = telemetry if telemetry is not None else Telemetry.null()
        # per-session telemetry columns only when the exporters are on; the
        # bare path keeps the lean [S, 3] readback
        self._pack = MetricPack.default() if self.obs.active else None
        S = cfg.slots
        x0, y0 = (np.asarray(a) for a in example)
        self._x0, self._y0 = x0, y0
        self._t_total = (cfg.t_total if cfg.t_total is not None
                         else float(cfg.update_every))
        self._template = self._fresh(params)
        self.session_carry_bytes = carry_nbytes(self._template[0])
        # the slot-stacked state, one buffer a leaf
        self.carry, self.opt_state = tree_map(
            lambda t: None if t is None
            else t[None].repeat((S,) + (1,) * t.dim()), self._template)
        self.sessions: dict[str, _Session] = {}
        self._slot_sid: list[str | None] = [None] * S
        self.windows = 0

    def _to(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _fresh(self, params: Tree) -> tuple[Tree, Tree]:
        """A new session's (carry, opt_state) from `params`."""
        carry = self.learner.init(params, self.masks,
                                  (self._to(self._x0), self._to(self._y0)),
                                  t_total=self._t_total)
        return carry, self.opt.init(params)

    # -- slot management ----------------------------------------------------

    @property
    def n_live(self) -> int:
        return sum(s is not None for s in self._slot_sid)

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._slot_sid) if s is None]

    def _claim(self, sid: str) -> int:
        if sid in self.sessions:
            raise ValueError(f"session {sid!r} already in the fleet")
        free = self.free_slots()
        if not free:
            raise ValueError(f"fleet is full ({self.cfg.slots} slots); "
                             "evict a session first")
        return free[0]

    def _write(self, slot: int, carry: Tree, opt_state: Tree) -> None:
        """Copy one session's state into its slot of the stacked buffers."""
        tree_map(lambda b, v: None if b is None else b[slot].copy_(v),
                 (self.carry, self.opt_state), (carry, opt_state))

    def _install(self, sess: _Session, carry: Tree, opt_state: Tree):
        self._write(sess.slot, carry, opt_state)
        self._slot_sid[sess.slot] = sess.sid
        self.sessions[sess.sid] = sess

    def add_session(self, sid: str, stream: Callable[[int], tuple],
                    params: Tree | None = None) -> int:
        """Join a fresh session mid-flight: a new carry and optimizer state
        from `params` (default: the fleet's template).  Returns the claimed
        slot; the fleet shape does not change."""
        slot = self._claim(sid)
        state = self._template if params is None else self._fresh(params)
        self._install(_Session(sid, stream, slot), *state)
        self.obs.registry.counter("sessions_joined_total").inc()
        self.obs.registry.gauge("sessions_live").set(self.n_live)
        self.obs.emit("session_join", sid=sid, slot=slot)
        return slot

    def remove(self, sid: str):
        """Leave without persisting (an abandoned session).  The freed slot
        is reset to the template, so the now-dead lane keeps grinding on
        bounded values."""
        sess = self.sessions.pop(sid)
        self._slot_sid[sess.slot] = None
        self._write(sess.slot, *self._template)
        self.obs.registry.counter("sessions_left_total").inc()
        self.obs.registry.gauge("sessions_live").set(self.n_live)
        self.obs.emit("session_leave", sid=sid, slot=sess.slot)

    def slot_state(self, sid: str) -> tuple[Tree, Tree]:
        """(carry, opt_state) of one session, copied out of the stack: the
        tensors are its own, so later slot writes leave them as they are."""
        slot = self.sessions[sid].slot
        return tree_map(lambda b: None if b is None else b[slot].clone(),
                        (self.carry, self.opt_state))

    # -- evict / resume: the session-keyed checkpoint store -----------------

    def _store(self) -> str:
        if self.cfg.store_dir is None:
            raise ValueError("FleetConfig.store_dir is unset — evict/resume "
                             "needs a session store")
        return self.cfg.store_dir

    def evict(self, sid: str) -> int:
        """Persist the session's full state — carry (params, influence,
        accumulators), optimizer moments, stream position, update count —
        under `store_dir/session/<sid>/` and free its slot.  Returns the
        stream position it will resume from."""
        store = self._store()
        sess = self.sessions[sid]
        carry, opt_state = self.slot_state(sid)
        tree = {"carry": carry, "opt": opt_state,
                "pos": np.int32(sess.pos), "upd": np.int32(sess.upd)}
        save_session(store, sid, tree, step=sess.upd,
                     extra={"pos": sess.pos})
        self.remove(sid)
        self.obs.registry.counter("sessions_evicted_total").inc()
        self.obs.emit("session_evict", sid=sid, pos=sess.pos)
        return sess.pos

    def resume(self, sid: str, stream: Callable[[int], tuple]) -> int:
        """Load an evicted session back into any free slot, bit for bit:
        the same carry, moments and stream position.  Returns the slot."""
        store = self._store()
        slot = self._claim(sid)
        like = {"carry": self._template[0], "opt": self._template[1],
                "pos": np.int32(0), "upd": np.int32(0)}
        tree, _ = load_session(store, sid, like)
        sess = _Session(sid, stream, slot,
                        pos=int(tree["pos"]), upd=int(tree["upd"]))
        self._install(sess, tree["carry"], tree["opt"])
        self.obs.registry.counter("sessions_resumed_total").inc()
        self.obs.registry.gauge("sessions_live").set(self.n_live)
        self.obs.emit("session_resume", sid=sid, slot=slot, pos=sess.pos)
        return slot

    # -- the steady-state loop ----------------------------------------------

    def _gather(self, k: int):
        """Host-side input assembly: every live session contributes its own
        next k stream steps at its own position; dead slots get zeros (their
        lanes' outputs are never read).  Returns numpy (xs, ys, upd,
        live)."""
        S = self.cfg.slots
        xs = np.zeros((S, k) + self._x0.shape, self._x0.dtype)
        ys = np.zeros((S, k) + self._y0.shape, self._y0.dtype)
        upd = np.zeros((S,), np.int32)
        live = np.zeros((S,), bool)
        for sess in self.sessions.values():
            for i in range(k):
                xs[sess.slot, i], ys[sess.slot, i] = sess.stream(sess.pos + i)
            upd[sess.slot] = sess.upd
            live[sess.slot] = True
        return xs, ys, upd, live

    def step_window(self) -> dict[str, dict]:
        """Advance every live session by one k-step window and one optimizer
        update: one vmapped chunk, one packed readback.  Returns {sid:
        {loss, overflow, pos, upd}} for the window (and the decoded
        `telemetry` dict with telemetry on)."""
        k = self.cfg.update_every
        xs, ys, upd, live = self._gather(k)
        t0 = time.perf_counter()
        with self.obs.span("window", window=self.windows,
                           live=int(live.sum())):
            self.carry, self.opt_state, packed = fleet_update_chunk(
                self.learner, self.opt, self.carry, self.opt_state,
                self._to(xs), self._to(ys), upd, self._to(live),
                pack=self._pack)
            pk = packed.cpu().numpy()                # the one readback
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.windows += 1
        reg = self.obs.registry
        reg.counter("fleet_windows_total").inc()
        reg.histogram("fleet_window_ms").observe(dt_ms)
        out = {}
        for sess in self.sessions.values():
            sess.pos += k
            sess.upd += 1
            sess.loss = float(pk[sess.slot, 1])
            sess.overflow = float(pk[sess.slot, 2])
            out[sess.sid] = {"loss": sess.loss, "overflow": sess.overflow,
                             "pos": sess.pos, "upd": sess.upd}
            if self._pack is not None:
                # the [3:] tail is the slot's MetricPack vector: labelled
                # per-session gauges, no extra readback
                m = self._pack.unpack(pk[sess.slot, 3:])
                out[sess.sid]["telemetry"] = m
                for name in ("loss", "grad_norm", "act_sparsity"):
                    v = m.get(name)
                    if v is not None and not np.isnan(v):
                        reg.gauge(f"session_{name}", sid=sess.sid).set(v)
                reg.gauge("session_pos", sid=sess.sid).set(sess.pos)
        self.obs.emit("fleet_window", window=self.windows,
                      live=int(live.sum()), dt_ms=dt_ms)
        return out

    def report(self) -> dict:
        out = {"slots": self.cfg.slots, "live": self.n_live,
               "windows": self.windows,
               "session_carry_bytes": self.session_carry_bytes,
               "fleet_carry_bytes": self.session_carry_bytes
               * self.cfg.slots}
        h = self.obs.registry.histogram("fleet_window_ms")
        if h.count:
            out["window_ms_p50"] = round(h.quantile(0.50), 3)
            out["window_ms_p99"] = round(h.quantile(0.99), 3)
        return out
