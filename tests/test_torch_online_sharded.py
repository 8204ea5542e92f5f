"""`runtime.online.OnlineTrainer` over a sharded scaled carry, on CPU gloo
groups: the carry placed by `ScaledLearner.place` on meshes (1, 2), (2, 1)
and (2, 2), against the same trainer on one device.

Three process groups, spawned once each (`launch.mesh.spawn`, a 150 s
join timeout that fails the test); the (2, 1) group resumes a checkpoint
the (1, 2) group wrote.  The ranks run `tests/_torch_online_sharded_worker.py`,
which imports neither `jax` nor `repro` (checked: every rank reports its
modules); they read the reference's parameters, masks and stream from a
pickle this process writes.  This process runs the same trainers on one
device and the reference's `OnlineTrainer` over its scaled learner.

What is held: each window's loss, the gradients the optimizer receives,
the parameters and optimizer state against one device within 1e-5 of each
tree's largest magnitude (the batch mean is summed over the batch shards
in another order); overflow, the row stats, the carry's bytes and the
packed telemetry's counts equal to one device's; every rank alike; a crash
and resume on the same mesh bitwise the uncrashed run; a checkpoint
written on (1, 2) resumed on (2, 1) within 1e-5 of the uncrashed (2, 1)
run; a corruption of rank 1's shard only rolling every rank back, the run
then bitwise the clean one; a RigL event's masks equal to one device's.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import learner as JL, scaled_rtrl as JSR
from repro.optim import optimizers as JO
from repro.runtime import online as JON
from repro_torch.launch import mesh as M

REL = 1e-5
TIMEOUT = 150
CFG = dict(n=32, n_in=8, batch=4, beta_capacity=0.5, sparsity=0.5)


@pytest.fixture(scope="module")
def W():
    import _torch_online_sharded_worker as W
    return W


@pytest.fixture(scope="module")
def case(W):
    jcfg = JSR.ScaledRTRLConfig(**CFG)
    jp, jm = JSR.init_params(jcfg, jax.random.key(0))
    rng = np.random.default_rng(3)
    T = W.K * W.WINDOWS
    xs = rng.standard_normal((T, jcfg.batch, jcfg.n_in)).astype(np.float32)
    ys = (np.arange(T * jcfg.batch).reshape(T, jcfg.batch)
          % jcfg.n_out).astype(np.int32)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return {"cfg": CFG, "params": np_tree(jp), "masks": np_tree(jm),
            "xs": xs, "ys": ys}


@pytest.fixture(scope="module")
def one(W, case, tmp_path_factory):
    """The same trainers on one device (this process, one intra-op thread:
    the ranks' groups run beside it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _one(W, case, tmp_path_factory.mktemp("one"))
    finally:
        torch.set_num_threads(threads)


def _one(W, case, tmp):
    grads = []
    tr = W.trainer(case, tmp / "base", grads_out=grads)
    out = {"base": W.summary(tr, tr.run())}
    out["base"]["grads"] = grads
    tr = W.trainer(case, tmp / "rewire", rewire=True)
    out["rewire"] = W.summary(tr, tr.run())
    from repro_torch.obs import MetricPack, Telemetry
    unpacked, unpack = [], MetricPack.unpack

    def counted(self, vec):
        unpacked.append(unpack(self, vec))
        return unpacked[-1]
    MetricPack.unpack = counted
    try:
        tr = W.trainer(case, tmp / "telemetry",
                       telemetry=Telemetry.create(tmp / "telemetry_dir"))
        out["telemetry"] = W.summary(tr, tr.run())
    finally:
        MetricPack.unpack = unpack
    out["telemetry"]["unpacked"] = unpacked
    return out


def _spawn(fn_name, world, tmp, inputs):
    import _torch_online_sharded_worker as W
    inp = tmp / "inputs.pkl"
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    M.spawn(getattr(W, fn_name), world, str(inp), str(tmp), timeout=TIMEOUT)
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def g12(case, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_1x2")
    return tmp, _spawn("mesh_1x2", 2, tmp, {"case": case})


@pytest.fixture(scope="module")
def groups(case, g12, tmp_path_factory):
    g22 = _spawn("mesh_2x2", 4, tmp_path_factory.mktemp("trainer_2x2"),
                 {"case": case})
    g21 = _spawn("mesh_2x1", 2, tmp_path_factory.mktemp("trainer_2x1"),
                 {"case": case, "ckpt_dir": str(g12[0] / "to_2x1")})
    return {(1, 2): g12[1], (2, 2): g22, (2, 1): g21}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _trees_close(got, want, what=""):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), what
    scale = max(max(float(np.abs(w).max()) for w in want if w.size), 1e-3)
    for g, w in zip(got, want):
        assert g.shape == w.shape, what
        err = float(np.abs(np.float64(g) - np.float64(w)).max()) if g.size \
            else 0.0
        assert err <= REL * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _trees_equal(a, b, what=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=what)


def _windows_close(got, want, what=""):
    assert len(got) == len(want), what
    scale = max(abs(w["loss"]) for w in want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), what
        assert abs(g["loss"] - w["loss"]) <= REL * scale, (what, g, w)
        assert g.get("overflow") == w.get("overflow"), (what, g, w)


MESHES = [(1, 2), (2, 1), (2, 2)]


@pytest.mark.parametrize("mesh", MESHES)
def test_windows_equal_one_device(W, groups, one, mesh):
    """Each window's loss and overflow, the gradients the optimizer
    receives, the parameters, optimizer state and influence state, the row
    stats and the carry's bytes: the whole batch's on every rank, as one
    device reads them; K1 once a step on the rank's own column half; no
    rank imported jax."""
    want = one["base"]
    ranks = groups[mesh]
    for r in ranks:
        assert r["jax_imported"] == []
        got = r["base"]
        _windows_close(got["windows"], want["windows"], "windows")
        assert any(w["overflow"] > 0 for w in want["windows"])
        assert len(got["grads"]) == len(want["grads"])
        for g, w in zip(got["grads"], want["grads"]):
            _trees_close(g, w, "gradients")
        _trees_close(got["params"], want["params"], "params")
        _trees_close(got["opt"], want["opt"], "optimizer state")
        _trees_close(got["state"], want["state"], "influence state")
        for k in ("row_stats", "carry_bytes", "carry_live_bytes", "updates",
                  "final_step"):
            assert got[k] == want[k], k
        full = want["state"]["vals"].shape
        assert r["local_vals"] == (full[0] // mesh[0], full[1],
                                   full[2] // mesh[1])
        assert r["k1_widths"] == [full[2] // mesh[1]] * (W.K * W.WINDOWS)
        _trees_equal(got, ranks[0]["base"], "ranks differ")


@pytest.mark.parametrize("mesh", MESHES)
def test_crash_and_resume_on_the_same_mesh_is_bitwise(groups, mesh):
    """A crash before update 4 (a checkpoint every 2 updates), resumed by
    a new trainer on the same mesh from the shard files: it ends bitwise
    where the uncrashed run on that mesh ends."""
    for r in groups[mesh]:
        got = r["crash"]
        assert got["resumed"] and got["resumed_at"] == (8, 2)
        for k in ("state", "params", "opt", "windows"):
            _trees_equal(got[k], r["base"][k] if k != "windows" else
                         r["base"]["windows"][2:], k)
        assert got["row_stats"] == r["base"]["row_stats"]


def test_checkpoint_written_on_1x2_resumes_on_2x1(groups):
    """The (1, 2) group's checkpoint at update 2, restored on (2, 1) by the
    learner's target shardings (the batch over 'data' now), ends within
    1e-5 of the uncrashed (2, 1) run."""
    for r in groups[(2, 1)]:
        got = r["remesh"]
        assert got["resumed"] and got["resumed_at"] == (8, 2)
        assert got["placements"] == "(Shard(dim=0), Shard(dim=2))"
        _windows_close(got["windows"], r["base"]["windows"][2:], "windows")
        for k in ("state", "params", "opt"):
            _trees_close(got[k], r["base"][k], k)


@pytest.mark.parametrize("mesh", MESHES)
def test_a_fault_in_one_ranks_shard_rolls_every_rank_back(groups, mesh):
    """Rank 1's local influence shard poisoned after update 2: every rank
    reads the same fault (the group's verdict) and rolls back to the same
    snapshot once; the replay heals it, and the run ends bitwise where the
    clean run ends."""
    ranks = groups[mesh]
    for r in ranks:
        rep = r["guard"]["report"]
        assert rep["rollbacks"] == 1, rep
        assert rep == ranks[0]["guard"]["report"]
        assert "carry" in rep["fault_log"][0]["reason"]
        for k in ("state", "params", "opt"):
            _trees_equal(r["guard"][k], r["base"][k], k)


@pytest.mark.parametrize("mesh", MESHES)
def test_rigl_event_through_the_trainer(groups, one, mesh):
    """One RigL event (after update 3) on the sharded rewirable carry,
    through `_maybe_rewire`: the masks are one device's, the windows,
    parameters and state within 1e-5, the live bytes one device's."""
    want = one["rewire"]
    assert want["rewire_events"] == 1
    for r in groups[mesh]:
        got = r["rewire"]
        assert got["rewire_events"] == 1
        _trees_equal(got["masks"], want["masks"], "masks")
        _windows_close(got["windows"], want["windows"], "windows")
        for k in ("state", "params", "opt"):
            _trees_close(got[k], want[k], k)
        assert got["carry_live_bytes"] == want["carry_live_bytes"]


@pytest.mark.parametrize("mesh", MESHES)
def test_telemetry_reads_the_whole_batch_once_a_window(groups, one, mesh):
    """With telemetry on, each rank reads its packed vector back once a
    window, and it holds the whole batch's values: the loss and gradient
    norm within 1e-5 of one device's, overflow, K_b and the guard fields
    equal."""
    want = one["telemetry"]["unpacked"]
    assert len(want) == 4
    for r in groups[mesh]:
        got = r["telemetry"]["unpacked"]
        assert len(got) == len(r["telemetry"]["windows"]) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in ("loss", "grad_norm"):
                assert abs(g[k] - w[k]) <= REL * abs(w[k]), (k, g, w)
            for k in ("overflow", "kb_min", "kb_mean", "kb_max",
                      "clip_factor", "health", "live_col_frac",
                      "act_sparsity", "bwd_sparsity"):
                np.testing.assert_equal(g[k], w[k], err_msg=k)


def test_one_device_trainer_equals_the_reference(case, one):
    """The one-device windows these tests hold the ranks to, against the
    reference's `OnlineTrainer` over its scaled learner on the same
    parameters, masks and stream: each window's loss within 1e-5, the
    overflow equal."""
    import _torch_online_sharded_worker as W
    jcfg = JSR.ScaledRTRLConfig(**CFG)
    jp = jax.tree.map(jnp.asarray, case["params"])
    jm = jax.tree.map(jnp.asarray, case["masks"])
    learner = JL.make_learner(JL.LearnerSpec(engine="scaled", cfg=jcfg,
                                             backend="compact"))
    opt = JO.masked(JO.adamw(lr=1e-2), {**jm, "out": None})
    xs, ys = case["xs"], case["ys"]
    tr = JON.OnlineTrainer(
        JON.OnlineTrainerConfig(total_steps=W.K * W.WINDOWS,
                                update_every=W.K, ckpt_every=0, log_every=1),
        learner, opt, jp, jm, lambda t: (xs[t], ys[t]))
    want = [{"loss": float(w["loss"]), "overflow": float(w["overflow"])}
            for w in tr.run()["metrics"]]
    got = [{"loss": w["loss"], "overflow": float(w["overflow"])}
           for w in one["base"]["windows"]]
    _windows_close(got, want, "one device vs the reference")
