"""The port's StreamGuard (`repro_torch.runtime.guard` and its
OnlineTrainer integration) held against the JAX package on the same numpy
problem, and against its own unguarded path.

Bars: health bits, detector verdicts, policies, guard reports and the
windows each trainer executes are equal to the JAX package's; inside the
port the guarded healthy path, a corrupt-carry rollback and replay and a
rollback across a rewire boundary are bitwise equal to the clean run.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cells as JC, learner as JL, sparse_rtrl as JSP
from repro.optim import optimizers as JO
from repro.runtime import guard as JG, online as JON
from repro_torch.core import cells as C, sparse_rtrl as SP
from repro_torch.core.learner import LearnerSpec, make_learner
from repro_torch.launch import train as TRAIN
from repro_torch.optim import optimizers as O
from repro_torch.runtime import guard as G, online as ON
from repro_torch.runtime.trainer import RETRYABLE, run_with_restart
from repro_torch.sparsity import RewireSchedule
from repro_torch.tree import tree_leaves
from repro_torch.weights import masks_from_numpy, params_from_numpy, to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small tensors: one intra-op thread a test process, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return jax.tree.map(np.asarray, t)


def _problem(seed=0, n=8, n_in=3, sparsity=0.5):
    """The reference test's problem: JAX-drawn params and masks, as numpy."""
    jcfg = JC.EGRUConfig(n_hidden=n, n_in=n_in, n_out=2, kind="gru")
    params = JC.init_params(jcfg, jax.random.key(seed))
    masks = JSP.make_masks(jcfg, jax.random.key(seed + 7), sparsity)
    return jcfg, _np(JSP.apply_masks(params, masks)), _np(masks)


def _stream(n_in=3, T=20, n_seq=40):
    xs_all = np.random.default_rng(0).normal(
        size=(n_seq, T, n_in)).astype(np.float32)
    ys_all = np.random.default_rng(1).integers(0, 2, size=(n_seq,))

    def stream(step):                    # step-keyed: replay-exact
        s, t = divmod(step, T)
        sel = np.random.default_rng(100 + s).integers(0, n_seq, size=4)
        return xs_all[sel][:, t], ys_all[sel]

    return stream


def _trainer(tmp_path, guard=None, plan=None, total=30, k=3, ckpt_every=0,
             fail_at=-1, backend="compact", rewire=None):
    """The port's trainer on the reference test's problem."""
    jcfg, params, masks = _problem()
    cfg = C.EGRUConfig(n_hidden=8, n_in=3, n_out=2, kind="gru")
    pm = masks_from_numpy(masks, "cpu")
    learner = make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                       backend=backend,
                                       rewirable=rewire is not None))
    wrap = O.masked if rewire is None else O.masked_dynamic
    opt = wrap(O.make_optimizer("adamw", lr=1e-2), dict(pm))
    ocfg = ON.OnlineTrainerConfig(total_steps=total, update_every=k,
                                  ckpt_every=ckpt_every,
                                  ckpt_dir=str(tmp_path), log_every=1,
                                  fail_at_update=fail_at)
    return ON.OnlineTrainer(ocfg, learner, opt,
                            params_from_numpy(params, "cpu"), pm, _stream(),
                            device="cpu", guard=guard, fault_plan=plan,
                            rewire_schedule=rewire)


def _jax_trainer(tmp_path, guard=None, plan=None, total=30, k=3):
    jcfg, params, masks = _problem()
    learner = JL.make_learner(JL.LearnerSpec(engine="sparse", cfg=jcfg,
                                             backend="compact"))
    opt = JO.masked(JO.make_optimizer("adamw", lr=1e-2),
                    jax.tree.map(jnp.asarray, masks))
    ocfg = JON.OnlineTrainerConfig(total_steps=total, update_every=k,
                                   ckpt_every=0, ckpt_dir=str(tmp_path),
                                   log_every=1)
    return JON.OnlineTrainer(ocfg, learner, opt,
                             jax.tree.map(jnp.asarray, params),
                             jax.tree.map(jnp.asarray, masks), _stream(),
                             guard=guard, fault_plan=plan)


def _carry_leaves(t):
    return [to_numpy(x) for x in tree_leaves(t.carry)
            if isinstance(x, torch.Tensor)]


def _all_finite(t):
    return all(np.isfinite(x).all() for x in _carry_leaves(t)
               if x.dtype.kind == "f")


def _assert_same_state(a, b):
    for x, y in zip(_carry_leaves(a) + [to_numpy(v) for v in
                                        tree_leaves(a.opt_state)],
                    _carry_leaves(b) + [to_numpy(v) for v in
                                        tree_leaves(b.opt_state)]):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# health bits, detectors, policies
# ---------------------------------------------------------------------------

_HEALTH_CASES = [
    (1.0, {"w": [1.0, 2.0, 3.0]}, {"a": [0.0] * 4}),
    (np.nan, {"w": [1.0]}, {"a": [0.0]}),
    (1.0, {"w": [1.0, np.inf, 0.0]}, {"a": [0.0]}),
    (1.0, {"w": [1.0]}, {"a": [np.nan]}),
    (np.nan, {"w": [np.nan]}, {"a": [np.nan]}),
    (np.inf, {}, {"a": [-np.inf, 0.0]}),
]


@pytest.mark.parametrize("case", range(len(_HEALTH_CASES)))
def test_health_bits_equal_reference_on_each_source(case):
    loss, grads, carry = _HEALTH_CASES[case]
    carry = dict(carry, idx=np.full((3,), 2 ** 31 - 1, np.int32))
    want = int(JG.health_bits(
        jnp.float32(loss), jax.tree.map(jnp.asarray, grads),
        {k: jnp.asarray(v) for k, v in carry.items()}))
    got = int(G.health_bits(
        torch.tensor(loss, dtype=torch.float32),
        {k: torch.tensor(v) for k, v in grads.items()},
        {k: torch.tensor(v) for k, v in carry.items()}))
    assert got == want
    assert G.describe_health(got) == JG.describe_health(want)


def test_nan_window_sets_health_bits_as_reference():
    """Grads and carry poisoned, the loss bit clear: the Heaviside gate
    silences the NaN state's output — why detection reads the carry."""
    jcfg, params, masks = _problem()
    cfg = C.EGRUConfig(n_hidden=8, n_in=3, n_out=2, kind="gru")
    stream = _stream()
    xs, ys = map(np.stack, zip(*(stream(i) for i in range(6))))
    xs[2] = np.nan
    pm = masks_from_numpy(masks, "cpu")
    learner = make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                       backend="compact"))
    p = params_from_numpy(params, "cpu")
    opt = O.masked(O.make_optimizer("adamw", lr=1e-2), dict(pm))
    carry = learner.init(p, pm, (torch.from_numpy(xs[0]),
                                 torch.from_numpy(ys[0])), t_total=6.0)
    _, _, m = G.guarded_update_chunk(learner, opt, carry, opt.init(p),
                                     torch.from_numpy(xs),
                                     torch.from_numpy(ys), 0, np.inf)
    assert int(m["health"]) == 6
    assert m["verdict"].tolist()[0] == 6.0


_DETECTOR_SEQS = {
    "overflow_streak": [dict(loss=0.5, overflow=o)
                        for o in (1, 1, 1, 1, 0, 1, 1, 1, 1)],
    "spike_after_warmup": [dict(loss=0.5 + 0.01 * np.sin(i))
                           for i in range(30)] + [dict(loss=50.0),
                                                  dict(loss=0.5)],
    "nonfinite_then_healthy": [dict(loss=0.4)] * 22 + [
        dict(health=1, loss=np.nan), dict(health=6, loss=0.4),
        dict(loss=0.41), dict(loss=9.0)],
}


@pytest.mark.parametrize("name", sorted(_DETECTOR_SEQS))
def test_detectors_equal_reference(name):
    """The same metric sequence through both guards: the same verdict at
    every window, and the same EMA state after it."""
    cfg = dict(overflow_streak=3, spike_z=6.0, spike_warmup=20)
    g, jg = G.StreamGuard(G.GuardConfig(**cfg)), \
        JG.StreamGuard(JG.GuardConfig(**cfg))
    got, want = [], []
    for u, m in enumerate(_DETECTOR_SEQS[name]):
        got.append(g.check(dict(m), u))
        want.append(jg.check({k: jnp.float32(v) for k, v in m.items()}, u))
    assert got == want
    assert any(v is not None for v in got)
    assert g._n_healthy == jg._n_healthy
    assert g._mu == pytest.approx(jg._mu, rel=1e-6)


def test_policies_and_config_equal_reference():
    for spec in ("full", "strict", "replay-only", "clip,quarantine",
                 ("replay", "skip_update")):
        assert G.resolve_policy(spec) == JG.resolve_policy(spec)
    for bad in ("replay,exorcism", ""):
        with pytest.raises(ValueError, match="unknown guard action"):
            G.resolve_policy(bad)
    with pytest.raises(ValueError, match="ring"):
        G.GuardConfig(ring=0)
    assert G.GuardConfig(policy="strict").policy == ("replay", "clip")
    assert G.POLICIES == JG.POLICIES and G.ACTIONS == JG.ACTIONS
    assert not issubclass(G.StreamFault, RETRYABLE)


# ---------------------------------------------------------------------------
# the guarded chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "pallas", "compact",
                                     "compact_fused"])
def test_guarded_chunk_bitwise_equals_unguarded(backend):
    """clip=+inf makes the clip factor exactly 1.0: the guarded chunk is
    the unguarded chunk bit for bit, plus a health of 0."""
    _, params, masks = _problem()
    cfg = C.EGRUConfig(n_hidden=8, n_in=3, n_out=2, kind="gru")
    pm = masks_from_numpy(masks, "cpu")
    stream = _stream()
    xs, ys = (torch.from_numpy(np.stack(a))
              for a in zip(*(stream(i) for i in range(6))))
    learner = make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                       backend=backend))
    p = params_from_numpy(params, "cpu")
    opt = O.masked(O.make_optimizer("adamw", lr=1e-2), dict(pm))
    carry = learner.init(p, pm, (xs[0], ys[0]), t_total=6.0)
    c_a, o_a, m_a = ON.online_update_chunk(learner, opt, carry, opt.init(p),
                                           xs, ys, 0)
    c_b, o_b, m_b = G.guarded_update_chunk(learner, opt, carry, opt.init(p),
                                           xs, ys, 0, np.inf)
    assert int(m_b["health"]) == 0
    assert torch.equal(m_a["loss"], m_b["loss"])
    for a, b in zip(tree_leaves((c_a, o_a)), tree_leaves((c_b, o_b))):
        assert torch.equal(a, b)


def test_clip_action_matches_reference():
    """The 'clip' rung: gradients scaled to the clip norm, as the JAX
    package scales them (params after the update within 1e-5)."""
    jcfg, params, masks = _problem()
    cfg = C.EGRUConfig(n_hidden=8, n_in=3, n_out=2, kind="gru")
    stream = _stream()
    xs, ys = map(np.stack, zip(*(stream(i) for i in range(6))))
    jl = JL.make_learner(JL.LearnerSpec(engine="sparse", cfg=jcfg,
                                        backend="compact"))
    jopt = JO.masked(JO.make_optimizer("adamw", lr=1e-2),
                     jax.tree.map(jnp.asarray, masks))
    jp = jax.tree.map(jnp.asarray, params)
    jc = jl.init(jp, jax.tree.map(jnp.asarray, masks),
                 (jnp.asarray(xs[0]), jnp.asarray(ys[0])), t_total=6.0)
    jc, _, jm = JG.guarded_update_chunk(jl, jopt, jc, jopt.init(jp),
                                        jnp.asarray(xs), jnp.asarray(ys),
                                        jnp.int32(0), jnp.float32(0.01))
    pm = masks_from_numpy(masks, "cpu")
    learner = make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                       backend="compact"))
    p = params_from_numpy(params, "cpu")
    opt = O.masked(O.make_optimizer("adamw", lr=1e-2), dict(pm))
    c = learner.init(p, pm, (torch.from_numpy(xs[0]),
                             torch.from_numpy(ys[0])), t_total=6.0)
    c, _, m = G.guarded_update_chunk(learner, opt, c, opt.init(p),
                                     torch.from_numpy(xs),
                                     torch.from_numpy(ys), 0, 0.01)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-5)
    assert float(m["grad_norm"]) > 0.01
    for a, b in zip(jax.tree.leaves(to_numpy(c["params"])),
                    jax.tree.leaves(_np(jc["params"]))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# end-to-end recovery, against the JAX trainer
# ---------------------------------------------------------------------------

def _count_windows(monkeypatch, cls):
    """Count the windows a trainer class executes (quarantined ones
    included)."""
    counts = {"windows": 0}
    orig = cls._execute_window

    def counted(self, start, k):
        counts["windows"] += 1
        return orig(self, start, k)

    monkeypatch.setattr(cls, "_execute_window", counted)
    return counts


def _report_core(g):
    return (g["faults"], g["rollbacks"], g["recoveries"], g["quarantined"])


def test_unguarded_nan_poisons_stream_forever(tmp_path):
    t = _trainer(tmp_path, plan=G.FaultPlan(nan_input_at=9, nan_input_len=3))
    out = t.run()
    assert out["final_step"] == 30
    assert not _all_finite(t)
    assert np.isfinite(out["metrics"][-1]["loss"])   # the silent part


def test_guarded_nan_escalates_to_quarantine_as_reference(tmp_path,
                                                          monkeypatch):
    """replay -> clip -> skip_update -> quarantine on the NaN window, all
    finite after it; the report and the windows executed equal the JAX
    trainer's, the final loss close to the clean run's."""
    clean = _trainer(tmp_path / "clean").run()
    ours = _count_windows(monkeypatch, ON.OnlineTrainer)
    theirs = _count_windows(monkeypatch, JON.OnlineTrainer)
    plan = dict(nan_input_at=9, nan_input_len=3)
    t = _trainer(tmp_path / "g", guard=G.GuardConfig(),
                 plan=G.FaultPlan(**plan))
    out = t.run()
    jout = _jax_trainer(tmp_path / "j", guard=JG.GuardConfig(),
                        plan=JG.FaultPlan(**plan)).run()
    assert _all_finite(t)
    g = out["guard"]
    assert _report_core(g) == _report_core(jout["guard"])
    assert g["quarantined"] == [{"start": 9, "len": 3, "update": 3}]
    assert g["recoveries"] == [{"step": 9, "action": "quarantine",
                                "attempts": 4}]
    assert ours["windows"] == theirs["windows"] == 10 + 4
    assert abs(out["metrics"][-1]["loss"]
               - clean["metrics"][-1]["loss"]) < 0.05
    quar = [m for m in out["metrics"] if m.get("guard_action")
            == "quarantine"]
    assert len(quar) == 1 and "loss" not in quar[0]


def test_corrupt_carry_rollback_replay_is_bitwise_clean(tmp_path,
                                                        monkeypatch):
    clean = _trainer(tmp_path / "clean")
    clean.run()
    ours = _count_windows(monkeypatch, ON.OnlineTrainer)
    theirs = _count_windows(monkeypatch, JON.OnlineTrainer)
    t = _trainer(tmp_path / "g", guard=G.GuardConfig(),
                 plan=G.FaultPlan(corrupt_carry_at_update=4))
    out = t.run()
    jout = _jax_trainer(tmp_path / "j", guard=JG.GuardConfig(),
                        plan=JG.FaultPlan(corrupt_carry_at_update=4)).run()
    g = out["guard"]
    assert _report_core(g) == _report_core(jout["guard"])
    assert (g["faults"], g["rollbacks"]) == (1, 1)
    assert g["recoveries"] == [{"step": 12, "action": "replay",
                                "attempts": 1}]
    assert ours["windows"] == theirs["windows"] == 11
    _assert_same_state(clean, t)


def test_policy_exhaustion_raises_stream_fault(tmp_path):
    t = _trainer(tmp_path, guard=G.GuardConfig(policy="replay-only"),
                 plan=G.FaultPlan(nan_input_at=9, nan_input_len=3))
    with pytest.raises(G.StreamFault, match="exhausted"):
        t.run()
    # a fault before the first push has no snapshot to return to
    t = _trainer(tmp_path, guard=G.GuardConfig())
    with pytest.raises(G.StreamFault, match="known-good"):
        t.guard.on_fault(t, "nonfinite:carry")


def test_corrupt_carry_builds_a_new_tensor():
    carry = {"vals": torch.ones((2, 3)), "idx": torch.zeros(2),
             "M": (torch.ones(4), torch.ones(4))}
    out = G.corrupt_carry(carry)
    assert torch.isnan(out["vals"][0, 0]) and bool(
        (carry["vals"] == 1).all())
    assert out["M"] is carry["M"]
    stacked = G.corrupt_carry({"M": (torch.ones(4), torch.ones(4))})
    assert isinstance(stacked["M"], tuple) and torch.isnan(stacked["M"][0][0])
    with pytest.raises(ValueError, match="influence"):
        G.corrupt_carry({"params": {"w": torch.ones(3)}})


@pytest.mark.parametrize("host_offload", [False, True])
def test_ring_tensors_unchanged_by_later_windows_and_corruption(
        tmp_path, host_offload):
    """The ring owns its tensors: a later window, a carry corruption, an
    in-place write on the live carry and a rollback leave every snapshot
    bitwise as pushed, and a rollback hands out tensors of its own."""
    t = _trainer(tmp_path, guard=G.GuardConfig(ring=2,
                                               host_offload=host_offload),
                 total=12)
    t.guard.push(t)
    snap = t.guard._ready(t.guard.ring[-1])
    frozen = [x.clone() for x in tree_leaves(snap.tree)
              if isinstance(x, torch.Tensor)]
    live = [x for x in tree_leaves(snap.tree) if isinstance(x, torch.Tensor)]
    assert not any(x.data_ptr() == y.data_ptr() for x in live
                   for y in tree_leaves(t._ckpt_tree())
                   if isinstance(y, torch.Tensor))
    t._execute_window(0, 3)
    t.carry = G.corrupt_carry(t.carry)
    for leaf in tree_leaves(t.carry):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            leaf.fill_(7.0)                  # the worst in-place writer
    t.guard.rollback(t)
    restored = [x for x in tree_leaves(t._ckpt_tree())
                if isinstance(x, torch.Tensor)]
    for leaf in restored:
        if leaf.is_floating_point():
            leaf.add_(1.0)
    for a, b in zip(frozen, [x for x in tree_leaves(snap.tree)
                             if isinstance(x, torch.Tensor)]):
        assert torch.equal(a, b)
    assert (t.step, t.update) == (0, 0)


# ---------------------------------------------------------------------------
# composition: rewire boundaries, crash supervisor, checkpoint faults
# ---------------------------------------------------------------------------

def test_rollback_across_rewire_boundary_replays_identical_masks(tmp_path):
    """Snapshots every 3 updates, events every 2, the carry corrupted after
    the event at update 4: the rollback lands on the update-3 snapshot
    (before the event), the replay fires event 1 again, and the masks,
    carry and event count end bitwise as the clean run's."""
    sched = RewireSchedule(method="set", every_k=2, frac=0.3, t_end=4)
    clean = _trainer(tmp_path / "clean", rewire=sched)
    out_c = clean.run()
    assert out_c["rewire_events"] >= 4
    t = _trainer(tmp_path / "g", rewire=sched,
                 guard=G.GuardConfig(snapshot_every=3),
                 plan=G.FaultPlan(corrupt_carry_at_update=4))
    out = t.run()
    g = out["guard"]
    assert g["rollbacks"] == 1
    assert g["recoveries"] == [{"step": 12, "action": "replay",
                                "attempts": 1}]
    assert out["rewire_events"] == out_c["rewire_events"]
    _assert_same_state(clean, t)


def test_guard_composes_with_crash_restart(tmp_path):
    trainers = []

    def make_trainer(attempt=0):
        t = _trainer(tmp_path, guard=G.GuardConfig(), ckpt_every=2,
                     fail_at=8 if attempt == 0 else -1,
                     plan=G.FaultPlan(nan_input_at=9, nan_input_len=3))
        trainers.append(t)
        return t

    out = run_with_restart(make_trainer)
    assert out["restarts"] == 1 and out["final_step"] == 30
    assert _all_finite(trainers[-1])
    assert trainers[0].guard.quarantined == [{"start": 9, "len": 3,
                                              "update": 3}]


def test_fault_plan_crash_restarts_from_the_landed_checkpoint(tmp_path):
    """The plan's crash, like --fail-at, lands the pending write first: the
    restart resumes from update 4 and replays only window 5."""
    out = run_with_restart(lambda attempt=0: _trainer(
        tmp_path, ckpt_every=2,
        plan=G.FaultPlan(crash_at_update=5 if attempt == 0 else -1)))
    assert out["restarts"] == 1 and out["final_step"] == 30
    assert [w["update"] for w in out["windows"]] == list(range(5, 11))


def test_ckpt_write_fault_retries_under_guard(tmp_path):
    t = _trainer(tmp_path, guard=G.GuardConfig(ckpt_retries=2), ckpt_every=2,
                 plan=G.FaultPlan(fail_ckpt_writes=1))
    out = t.run()
    assert out["final_step"] == 30
    assert t.ckpt.latest_step() == out["updates"]


def test_ckpt_write_failure_is_retryable_by_supervisor(tmp_path):
    def make_trainer(attempt=0):
        plan = G.FaultPlan(fail_ckpt_writes=2) if attempt == 0 else None
        return _trainer(tmp_path, ckpt_every=2, plan=plan)

    out = run_with_restart(make_trainer)
    assert out["restarts"] == 1 and out["final_step"] == 30


# ---------------------------------------------------------------------------
# the launcher: the chip smoke run's fault plans, windows against the JAX
# launcher's on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("faults,windows", [
    (["--inject-corrupt-at", "6"], 21),
    (["--inject-nan-at", "40", "--inject-nan-len", "8"], 24)])
def test_launcher_guard_windows_equal_reference(faults, windows, tmp_path,
                                                monkeypatch):
    """`--guard` with the fault plans of the chip smoke run (20 updates of
    k = 8 at full width, compact here): the same windows executed and the
    same guard report as the JAX launcher — so the card's K1 count is
    8 x (windows - quarantined)."""
    argv = ["--arch", "egru-spiral", "--online", "--rtrl-backend", "compact",
            "--sparsity", "0.8", "--steps", "20", "--ckpt-every", "0",
            "--guard", *faults]
    ours = _count_windows(monkeypatch, ON.OnlineTrainer)
    theirs = _count_windows(monkeypatch, JON.OnlineTrainer)
    out = TRAIN.main(argv + ["--device", "cpu"])
    from repro.launch import train as JTRAIN
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--ckpt-dir",
                                      str(tmp_path)])
    jout = {}
    orig_run = JON.OnlineTrainer.run

    def run(self):
        jout.update(orig_run(self))
        return jout

    monkeypatch.setattr(JON.OnlineTrainer, "run", run)
    JTRAIN.main()
    assert ours["windows"] == theirs["windows"] == windows
    assert _report_core(out["guard"]) == _report_core(jout["guard"])
    assert out["summary"]["guard"]["rollbacks"] == out["guard"]["rollbacks"]
