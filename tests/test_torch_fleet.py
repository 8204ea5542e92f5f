"""The port's stream fleet (`repro_torch.runtime.fleet`), its session store
and `launch.serve --fleet`, held against the port's solo trainer and
against the JAX package's fleet.

Bars, as the reference pins its own (tests/test_fleet.py,
tests/test_obs.py): a fleet of 1 is bitwise the solo `OnlineTrainer`;
a slot that joins and leaves moves no bit of its neighbours; evict and
resume round-trip bitwise; the packed chunk's carry and optimizer state are
bitwise the bare chunk's.  Against the JAX fleet on the same numpy params,
masks and streams: window losses and the slots' leaves within 1e-5 of each
leaf's largest entry over 3 windows (float32 sums associated differently
by the two libraries), and a session either package evicted resumes in the
other with the file's bits.  On the CPU, K1 and K2 run their plain versions
on the folded slots.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JCK
from repro.core import cells as JC, learner as JL, sparse_rtrl as JSP
from repro.launch import serve as JSERVE
from repro.optim import optimizers as JO
from repro.runtime import fleet as JF
from repro_torch.checkpoint import (CheckpointError, list_sessions,
                                    load_session, save_session)
from repro_torch.core import cells as C, sparse_rtrl as SP
from repro_torch.core.learner import LearnerSpec, make_learner
from repro_torch.kernels import compact as CK
from repro_torch.launch import serve as SERVE
from repro_torch.obs import MetricPack, Telemetry, read_events
from repro_torch.obs.metricpack import global_norm
from repro_torch.obs.validate import validate_dir
from repro_torch.optim import optimizers as O
from repro_torch.runtime.fleet import (FleetConfig, StreamFleet,
                                       fleet_update_chunk)
from repro_torch.runtime.online import OnlineTrainer, OnlineTrainerConfig
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import masks_from_numpy, params_from_numpy, to_numpy

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small tensors: one intra-op thread a test process, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(backend="compact", col=True, n=8, seed=0):
    """The reference's fleet test configuration (EGRU kind gru, n_in 3,
    n_out 2, sparsity 0.5, adamw 1e-2), drawn from torch.Generators."""
    cfg = C.EGRUConfig(n_hidden=n, n_in=3, n_out=2, kind="gru")
    masks = SP.make_masks(cfg, torch.Generator().manual_seed(seed + 7), 0.5,
                          device="cpu")
    learner = make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                       backend=backend, col_compact=col))
    opt = O.make_optimizer("adamw", lr=1e-2)
    params = SP.apply_masks(C.init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu"), masks)
    return cfg, masks, learner, opt, params


def _stream(salt=0, B=4):
    def stream(step):
        rng = np.random.default_rng(1000 + salt * 777 + step % 20)
        x = rng.standard_normal((B, 3)).astype(np.float32)
        return x, (np.arange(B) % 2).astype(np.int32)
    return stream


def _fleet(learner, opt, params, masks, slots, k, telemetry=None, **kw):
    return StreamFleet(FleetConfig(slots=slots, update_every=k, **kw),
                       learner, opt, params, masks, example=_stream()(0),
                       device="cpu", telemetry=telemetry)


def _tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _stack(tree, S):
    return tree_map(lambda t: None if t is None
                    else t[None].repeat((S,) + (1,) * t.dim()), tree)


_BACKENDS = [("compact", True), ("compact", False), ("compact_fused", True),
             ("pallas", True), ("dense", False)]


# ---------------------------------------------------------------------------
# the reference's pins (tests/test_fleet.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,col", _BACKENDS)
def test_fleet_of_one_bitwise_equals_solo(backend, col):
    """The acceptance bar: an S=1 fleet equals the solo OnlineTrainer, every
    carry and optimizer leaf bit for bit, after 8 update windows."""
    cfg, masks, learner, opt, params = _setup(backend, col)
    stream = _stream()
    tr = OnlineTrainer(OnlineTrainerConfig(total_steps=24, update_every=3),
                       learner, opt, params, masks, stream, device="cpu")
    tr.run()
    fleet = _fleet(learner, opt, params, masks, 1, 3)
    fleet.add_session("u0", stream, params=params)
    for _ in range(8):
        stats = fleet.step_window()
    carry_f, opt_f = fleet.slot_state("u0")
    _tree_equal(tr.carry, carry_f)
    _tree_equal(tr.opt_state, opt_f)
    assert stats["u0"]["pos"] == 24 and stats["u0"]["upd"] == 8
    assert stats["u0"]["loss"] == tr.windows[-1]["loss"]


@pytest.mark.parametrize("backend", ["compact", "compact_fused", "pallas"])
def test_join_leave_mid_flight_leaves_neighbours_bit_identical(backend):
    """A session joining at window 2 and leaving at window 5 moves no bit
    of any other slot: continuous batching is lane-exact, K1's and K2's
    folds included."""
    cfg, masks, learner, opt, params = _setup(backend)
    streams = {f"u{i}": _stream(salt=i) for i in range(3)}

    def run(with_guest):
        fleet = _fleet(learner, opt, params, masks, 4, 2)
        for sid in streams:
            fleet.add_session(sid, streams[sid], params=params)
        for w in range(8):
            if with_guest and w == 2:
                fleet.add_session("guest", _stream(salt=99), params=params)
            if with_guest and w == 5:
                fleet.remove("guest")
            fleet.step_window()
        return {sid: fleet.slot_state(sid) for sid in streams}

    alone = run(with_guest=False)
    shared = run(with_guest=True)
    for sid in streams:
        _tree_equal(alone[sid], shared[sid])


def test_evict_resume_roundtrip_bitwise(tmp_path):
    """Evict a session to the store mid-stream, run other traffic, resume
    into another slot: the end state equals the never-evicted run's."""
    cfg, masks, learner, opt, params = _setup()
    stream = _stream(salt=3)
    store = str(tmp_path / "store")

    def run(evict):
        fleet = _fleet(learner, opt, params, masks, 2, 2, store_dir=store)
        fleet.add_session("a", stream, params=params)
        for _ in range(3):
            fleet.step_window()
        if evict:
            assert fleet.evict("a") == 6
            assert list_sessions(store) == ["a"]
            # unrelated traffic while "a" is parked
            fleet.add_session("filler", _stream(salt=8), params=params)
            fleet.step_window()
            assert fleet.resume("a", stream) == 1
            fleet.remove("filler")
        for _ in range(3):
            fleet.step_window()
        return fleet.slot_state("a"), fleet.sessions["a"]

    (c_ref, o_ref), _ = run(evict=False)
    (c_ev, o_ev), sess = run(evict=True)
    _tree_equal(c_ref, c_ev)
    _tree_equal(o_ref, o_ev)
    assert sess.pos == 12 and sess.upd == 6


def test_slot_state_is_a_copy_not_a_view():
    """Slot writes are in-place copies into the stacked buffers, so a state
    read out before a later join and window must keep its values."""
    cfg, masks, learner, opt, params = _setup()
    fleet = _fleet(learner, opt, params, masks, 1, 2)
    fleet.add_session("a", _stream(1), params=params)
    fleet.step_window()
    before = fleet.slot_state("a")
    kept = tree_map(torch.clone, before)
    fleet.remove("a")
    fleet.add_session("b", _stream(2))
    fleet.step_window()
    _tree_equal(before, kept)


def test_dead_slots_emit_no_stats_and_cost_no_bookkeeping():
    """Dead slots never appear in window stats, and the packed readback
    masks their rows to live=0."""
    cfg, masks, learner, opt, params = _setup()
    fleet = _fleet(learner, opt, params, masks, 4, 2)
    fleet.add_session("only", _stream(), params=params)
    stats = fleet.step_window()
    assert set(stats) == {"only"}
    assert np.isfinite(stats["only"]["loss"])
    xs, ys, upd, live = fleet._gather(2)
    assert live.tolist() == [True, False, False, False]
    _, _, packed = fleet_update_chunk(
        learner, opt, fleet.carry, fleet.opt_state, torch.from_numpy(xs),
        torch.from_numpy(ys), upd, torch.from_numpy(live))
    pk = packed.numpy()
    assert pk.shape == (4, 3)
    assert pk[0, 0] == 1.0 and (pk[1:, 0] == 0.0).all()
    assert (pk[1:, 1:] == 0.0).all()


def test_slot_exhaustion_and_duplicate_sid_raise():
    cfg, masks, learner, opt, params = _setup()
    fleet = _fleet(learner, opt, params, masks, 1, 2)
    fleet.add_session("a", _stream(), params=params)
    with pytest.raises(ValueError, match="already"):
        fleet.add_session("a", _stream())
    with pytest.raises(ValueError, match="full"):
        fleet.add_session("b", _stream())
    fleet.remove("a")
    assert fleet.n_live == 0
    fleet.add_session("b", _stream())
    assert fleet.n_live == 1
    with pytest.raises(ValueError, match="store_dir"):
        fleet.evict("b")


def test_session_store_namespacing_and_validation(tmp_path):
    """save_session namespaces under session/<sid>; hostile sids are
    rejected; a session never saved raises CheckpointError."""
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    p = save_session(str(tmp_path), "user-1", tree, step=2)
    assert "session/user-1" in str(p).replace("\\", "/")
    got, step = load_session(str(tmp_path), "user-1", tree)
    assert step == 2
    assert torch.equal(got["w"], torch.arange(4, dtype=torch.float32))
    for bad in ("../evil", "a/b", "", "x y", ".", ".."):
        with pytest.raises(ValueError):
            save_session(str(tmp_path), bad, tree)
    with pytest.raises(CheckpointError):
        load_session(str(tmp_path), "never-saved", tree)
    assert list_sessions(str(tmp_path)) == ["user-1"]
    assert list_sessions(str(tmp_path / "empty")) == []


# ---------------------------------------------------------------------------
# the reference's telemetry pins (tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_packed_fleet_chunk_bitwise_equals_bare():
    """The vmapped chunk with per-lane pack rows is bitwise the bare fleet
    chunk, and the packed [S, 3+F] rows agree with the bare [S, 3]
    columns."""
    cfg, masks, learner, opt, params = _setup()
    k, S = 3, 3
    rng = np.random.default_rng(100)
    xs1 = torch.from_numpy(rng.standard_normal((k, 4, 3)).astype(np.float32))
    ys1 = torch.arange(4, dtype=torch.int32).remainder(2).expand(k, 4)
    xs = torch.stack([xs1 + 0.1 * s for s in range(S)])
    ys = ys1.expand(S, k, 4).contiguous()
    carry = learner.init(params, masks, (xs1[0], ys1[0]), t_total=float(k))
    stack = _stack((carry, opt.init(params)), S)
    upd = np.zeros(S, np.int32)
    live = torch.tensor([True, True, False])      # one dead don't-care lane
    pack = MetricPack.default()
    c_a, o_a, m_a = fleet_update_chunk(learner, opt, *stack, xs, ys, upd,
                                       live)
    c_b, o_b, m_b = fleet_update_chunk(learner, opt, *stack, xs, ys, upd,
                                       live, pack=pack)
    _tree_equal((c_a, o_a), (c_b, o_b))
    assert m_b.shape == (S, 3 + len(pack.names))
    assert torch.equal(m_a, m_b[:, :3])
    m0 = pack.unpack(m_b[0, 3:])
    assert np.float32(m0["loss"]) == m_a[0, 1].item()
    assert m0["grad_norm"] > 0.0 and m0["kb_max"] >= m0["kb_min"]


def test_fleet_session_lifecycle_events(tmp_path):
    """A fleet with active telemetry: join/evict/resume/leave each emit
    their event, per-session labelled gauges land, and step_window returns
    the decoded per-session telemetry tail."""
    cfg, masks, learner, opt, params = _setup()
    obs = Telemetry.create(tmp_path / "m")
    fleet = _fleet(learner, opt, params, masks, 2, 2,
                   store_dir=str(tmp_path / "store"), telemetry=obs)
    fleet.add_session("a", _stream(1), params=params)
    fleet.add_session("b", _stream(2), params=params)
    stats = fleet.step_window()
    assert "telemetry" in stats["a"]
    assert stats["a"]["telemetry"]["loss"] == stats["a"]["loss"]
    fleet.evict("a")
    fleet.resume("a", _stream(1))
    stats2 = fleet.step_window()
    fleet.remove("b")
    obs.finalize()
    assert validate_dir(tmp_path / "m") == []
    kinds = [e["kind"] for e in read_events(tmp_path / "m" / "events.jsonl")]
    for k in ("session_join", "session_evict", "session_resume",
              "session_leave", "fleet_window"):
        assert k in kinds, k
    reg = obs.registry
    assert reg.counter("sessions_joined_total").value == 2
    assert reg.counter("sessions_evicted_total").value == 1
    assert reg.counter("sessions_resumed_total").value == 1
    assert reg.counter("sessions_left_total").value == 2
    assert reg.gauge("session_loss", sid="a").value == np.float32(
        stats2["a"]["loss"])                 # last write wins: window 2
    rep = fleet.report()
    assert rep["window_ms_p50"] > 0 and rep["window_ms_p99"] > 0
    assert rep["fleet_carry_bytes"] == 2 * rep["session_carry_bytes"]


# ---------------------------------------------------------------------------
# the repairs the vmapped chunk needs
# ---------------------------------------------------------------------------

def test_check_idx_skips_vmapped_slots_and_still_checks_plain_tensors():
    idx = torch.tensor([[0, 3, -1], [2, -1, -1]], dtype=torch.int32)
    cbar = torch.randn(2, 4)
    vals = torch.randn(2, 3, 8)
    got = torch.func.vmap(CK.compact_grads)(vals[None].expand(2, -1, -1, -1),
                                            idx[None].expand(2, -1, -1),
                                            cbar[None].expand(2, -1, -1))
    assert torch.equal(got[1], CK.compact_grads(vals, idx, cbar))
    with pytest.raises(ValueError, match="sentinel"):
        CK.check_idx(torch.tensor([[0, 4]], dtype=torch.int32), 4)


def test_global_norm_gives_each_vmapped_slot_its_own_norm():
    g = torch.Generator().manual_seed(3)
    tree = {"a": torch.randn(3, 5, 4, generator=g),
            "b": {"c": torch.randn(3, 7, generator=g)}}
    got = torch.func.vmap(global_norm)(tree)
    want = torch.stack([global_norm(tree_map(lambda t: t[s], tree))
                        for s in range(3)])
    assert got.shape == (3,)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("backend,col", _BACKENDS)
def test_vmapped_step_is_bitwise_the_unbatched_step(backend, col):
    """Every op of a learner step rounds in a vmapped slot as it does
    unbatched: the small products (`cells.slot_mm`) included."""
    cfg, masks, learner, opt, params = _setup(backend, col)
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.standard_normal((2, 3, 4, 3)).astype(np.float32))
    ys = torch.arange(4, dtype=torch.int32).remainder(2)
    carry = learner.init(params, masks, (xs[0, 0], ys), t_total=3.0)
    solo = [carry, carry]
    batched = _stack(carry, 2)
    step = lambda c, x, y: learner.step(c, x, y)[0]
    for t in range(3):
        solo = [step(solo[s], xs[s, t], ys) for s in range(2)]
        batched = torch.func.vmap(step, in_dims=(0, 0, None))(
            batched, xs[:, t], ys)
    for s in range(2):
        _tree_equal(solo[s], tree_map(lambda b: b[s], batched))


@pytest.mark.parametrize("wrap", ["adamw", "masked", "masked_dynamic"])
def test_adamw_slot_steps_give_each_slot_its_bias_correction(wrap):
    """Slots at update counts 0, 3 and 40 through one vmapped update: each
    slot bitwise the unbatched update at its own count."""
    cfg, masks, learner, opt, params = _setup()
    # the readout's None mask left out: vmap takes no None operand
    mtree = {k: v for k, v in masks.items() if v is not None}
    if wrap == "masked":
        opt = O.masked(opt, mtree)
    elif wrap == "masked_dynamic":
        opt = O.masked_dynamic(opt, mtree)
    g = torch.Generator().manual_seed(1)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g), params)
    state = opt.init(params)
    counts = [0, 3, 40]
    want = [opt.update(grads, state, params, c) for c in counts]
    S = len(counts)
    got = torch.func.vmap(opt.update)(
        _stack(grads, S), _stack(state, S), _stack(params, S),
        opt.slot_steps(counts, "cpu"))
    for s in range(S):
        _tree_equal(want[s], tree_map(
            lambda b: None if b is None else b[s], got))


# ---------------------------------------------------------------------------
# against the JAX package's fleet
# ---------------------------------------------------------------------------

def _reference_setup(n=8, seed=0):
    """JAX-drawn params and masks of the fleet configuration, as numpy."""
    jcfg = JC.EGRUConfig(n_hidden=n, n_in=3, n_out=2, kind="gru")
    masks = JSP.make_masks(jcfg, jax.random.key(seed + 7), 0.5)
    params = JSP.apply_masks(JC.init_params(jcfg, jax.random.key(seed)),
                             masks)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return jcfg, np_tree(params), np_tree(masks)


def _both_fleets(slots=3, k=3, store=None):
    jcfg, params_np, masks_np = _reference_setup()
    jt = lambda t: jax.tree.map(jnp.asarray, t)
    jfleet = JF.StreamFleet(
        JF.FleetConfig(slots=slots, update_every=k, store_dir=store),
        JL.make_learner(JL.LearnerSpec(engine="sparse", cfg=jcfg,
                                       backend="compact", col_compact=True)),
        JO.make_optimizer("adamw", lr=1e-2), jt(params_np), jt(masks_np),
        example=_stream()(0))
    cfg = C.EGRUConfig(n_hidden=8, n_in=3, n_out=2, kind="gru")
    masks = masks_from_numpy(masks_np, "cpu")
    fleet = StreamFleet(
        FleetConfig(slots=slots, update_every=k, store_dir=store),
        make_learner(LearnerSpec(engine="sparse", cfg=cfg, backend="compact",
                                 col_compact=True)),
        O.make_optimizer("adamw", lr=1e-2), params_from_numpy(params_np,
                                                              "cpu"),
        masks, example=_stream()(0), device="cpu")
    return jfleet, fleet


def _assert_close(got, want):
    got = jax.tree.leaves(to_numpy(got))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(g, w, rtol=0, atol=REL * scale)


def test_fleet_matches_reference_with_staggered_joins():
    """Three sessions joining at windows 0, 1 and 2 (update counts 3, 2
    and 1 after window 2): every window's per-session loss and every
    slot's leaves agree with the JAX fleet's."""
    jfleet, fleet = _both_fleets()
    for w, sid in enumerate(("a", "b", "c")):
        for f in (jfleet, fleet):
            f.add_session(sid, _stream(salt=w + 1))
        want, got = jfleet.step_window(), fleet.step_window()
        assert set(got) == set(want)
        for s in want:
            assert got[s]["upd"] == want[s]["upd"]
            assert got[s]["pos"] == want[s]["pos"]
            assert got[s]["loss"] == pytest.approx(want[s]["loss"], rel=REL)
    assert [fleet.sessions[s].upd for s in "abc"] == [3, 2, 1]
    for sid in "abc":
        _assert_close(fleet.slot_state(sid), jfleet.slot_state(sid))


def test_sessions_cross_the_package_boundary(tmp_path):
    """A session the JAX fleet evicted resumes in the port's fleet with the
    file's bits, and one the port evicted resumes in the JAX fleet."""
    store = str(tmp_path / "store")
    jfleet, fleet = _both_fleets(slots=2, store=store)
    stream = _stream(salt=4)
    jfleet.add_session("u1", stream)
    jfleet.step_window()
    jfleet.step_window()
    j_state = jfleet.slot_state("u1")
    assert jfleet.evict("u1") == 6
    fleet.add_session("other", _stream(salt=5))
    assert fleet.resume("u1", stream) == 1
    assert fleet.sessions["u1"].pos == 6 and fleet.sessions["u1"].upd == 2
    for g, w in zip(jax.tree.leaves(to_numpy(fleet.slot_state("u1"))),
                    jax.tree.leaves(jax.tree.map(np.asarray, j_state))):
        np.testing.assert_array_equal(g, w)
    fleet.step_window()
    t_state = fleet.slot_state("u1")
    assert fleet.evict("u1") == 9
    assert jfleet.resume("u1", stream) == 0
    for g, w in zip(jax.tree.leaves(to_numpy(t_state)),
                    jax.tree.leaves(jax.tree.map(
                        np.asarray, jfleet.slot_state("u1")))):
        np.testing.assert_array_equal(g, w)
    assert jfleet.sessions["u1"].upd == 3
    assert JCK.list_sessions(store) == list_sessions(store) == ["u1"]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_FLEET_ARGV = ["--fleet", "--smoke", "--requests", "3", "--slots", "2"]


def test_serve_fleet_smoke_on_cpu_has_the_reference_summary(tmp_path,
                                                            capsys):
    """`launch.serve --fleet --smoke --device cpu`: every session
    completes, the summary has the reference's keys, fleet_windows equals
    the reference's for the same flags, and --metrics-dir validates."""
    d = tmp_path / "m"
    out = SERVE.main([*_FLEET_ARGV, "--device", "cpu", "--metrics-dir",
                      str(d)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    args = argparse.Namespace(smoke=True, requests=3, slots=2,
                              session_windows=12, update_every=8,
                              metrics_dir=None, trace=False)
    want = JSERVE._fleet_main(args)
    s = out["summary"]
    assert printed == s
    assert set(s) == set(want)
    assert s["fleet_windows"] == want["fleet_windows"] == 6
    assert s["session_carry_bytes"] == want["session_carry_bytes"]
    assert sorted(out["completed"]) == ["s0", "s1", "s2"]
    assert validate_dir(d) == []
    kinds = [e["kind"] for e in read_events(d / "events.jsonl")]
    assert kinds.count("session_join") == 3
    assert kinds.count("session_leave") == 3
    assert kinds.count("fleet_window") == 6


def test_serve_fleet_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SERVE.main(_FLEET_ARGV)
