"""The stacked engine (`--layers L`, L >= 2) through the port's launcher,
its checkpoints and its restart supervisor, on the CPU; and a JAX-written
two-layer carry checkpoint resumed in the port.

Tolerances: window losses and gradients across backends, and across the
two packages, agree to 1e-5 of the gradient tree's largest magnitude;
inside the port a crashed and resumed run equals the uncrashed one bit for
bit.  Every run gets its own checkpoint directory.
"""
import json
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from repro.runtime import online as JON
from repro_torch.checkpoint import load_checkpoint
from repro_torch.core import bptt as BP, cells as C, stacked_rtrl as ST
from repro_torch.core.learner import LearnerSpec, make_learner
from repro_torch.launch import train as TRAIN
from repro_torch.optim import optimizers as O
from repro_torch.runtime import online as ON
from repro_torch.tree import leaf_name, tree_flatten_with_path
from repro_torch.weights import masks_from_numpy, params_from_numpy, to_numpy

REL = 1e-5
BACKENDS = ("dense", "pallas", "compact", "compact_fused")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The tensors here are small: one intra-op thread a test process, so
    that parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree):
    """The leaves of a tree of tensors or arrays, as float/int numpy."""
    return [to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in jax.tree.leaves(tree)]


def _assert_trees_close(got, want, rel=REL):
    """Every leaf within rel of the tree's largest magnitude."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    scale = max(max(float(np.abs(w).max()) for w in want), 1e-3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale)


def _argv(layers, backend, tmp_path, *extra, online=True):
    argv = ["--arch", "egru-spiral", "--layers", str(layers),
            "--rtrl-backend", backend, "--sparsity", "0.8", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ck"), *extra]
    return argv + ["--online"] if online else argv


@pytest.mark.parametrize("layers,backend", [(L, b) for L in (2, 3)
                                            for b in BACKENDS])
@pytest.mark.parametrize("online", [True, False])
def test_launcher_trains_stacked_on_cpu(layers, backend, online, tmp_path,
                                        capsys):
    """`--layers L --device cpu --smoke --ckpt-every 0` with every backend,
    online and offline."""
    steps = ["--steps", "2", "--update-every", "4"] if online \
        else ["--steps", "1"]
    out = TRAIN.main(_argv(layers, backend, tmp_path, "--smoke",
                           "--ckpt-every", "0", *steps, online=online))
    s = out["summary"]
    assert (s["layers"], s["backend"], s["device"]) == (layers, backend,
                                                        "cpu")
    assert s["final_step"] == (8 if online else 1)
    assert np.isfinite([s["first_loss"], s["final_loss"]]).all()
    printed = capsys.readouterr().out
    assert json.loads(printed.strip().splitlines()[-1]) == s
    assert ("col-compact carry ON" in printed) == (backend != "dense")
    if online:
        assert s["overflow"] == 0
        assert out["carry_bytes"] == out["carry_live_bytes"] > 0
        rs = out.get("row_stats")
        assert (rs is not None) == backend.startswith("compact")
        if rs is not None:
            assert len(rs["layers"]) == layers
            assert rs["k_max"] <= 16 and rs["influence_dtype"] == "float32"


def test_launcher_stacked_raises_without_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRAIN.main(["--arch", "egru-spiral", "--layers", "2", "--online",
                    "--sparsity", "0.8", "--steps", "1"])


def _first_window(argv):
    """Loss and gradients of a launcher run's first window (k=8), with the
    run's own params, masks and stream, and the run."""
    run = TRAIN.build_online(TRAIN.parse_args(argv))
    xs, ys = zip(*(run["stream"](t) for t in range(8)))
    xs, ys = torch.from_numpy(np.stack(xs)), torch.from_numpy(np.stack(ys))
    carry = run["learner"].init(run["params"], run["masks"], (xs[0], ys[0]),
                                t_total=8.0)
    carry, loss, grads, stats = ON.stream_grads(run["learner"], carry, xs, ys)
    return float(loss), grads, stats, run, xs, ys


def test_stacked_first_window_backends_agree_with_bptt(tmp_path):
    """At the launcher's full width (two layers of 16, batch 32): the
    first window of pallas and compact_fused against compact and against
    the stacked BPTT oracle on surviving parameters."""
    lc, gc, _, run, xs, ys = _first_window(_argv(2, "compact", tmp_path))
    assert bool((ys == ys[0]).all())
    bl, bg, _ = BP.stacked_bptt_loss_and_grads(run["cfg"], run["params"], xs,
                                               ys[0])
    assert lc == pytest.approx(float(bl), rel=REL)
    survivors = lambda g: ST.apply_stacked_masks(g, run["masks"])
    _assert_trees_close(survivors(gc), survivors(bg))
    for backend in ("pallas", "compact_fused"):
        lb, gb, stats, _, _, _ = _first_window(_argv(2, backend, tmp_path))
        assert lb == pytest.approx(lc, rel=REL), backend
        _assert_trees_close(gb, gc)
        assert tuple(stats["alpha_layers"].shape) == (8, 2)


# ---------------------------------------------------------------------------
# crash and resume
# ---------------------------------------------------------------------------

def _ckpt_like(argv):
    args = TRAIN.parse_args(argv)
    if args.online:
        return TRAIN.online_trainers(args, TRAIN.build_online(args))(1) \
            ._ckpt_tree()
    return TRAIN.offline_trainers(args, TRAIN.build_offline(args))(1) \
        ._ckpt_tree()


def _assert_checkpoints_bitwise(root_a, root_b, like):
    ta, sa = load_checkpoint(root_a, like)
    tb, sb = load_checkpoint(root_b, like)
    assert sa == sb >= 0
    la, lb = tree_flatten_with_path(ta), tree_flatten_with_path(tb)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, a), (_, b) in zip(la, lb):
        if path == ("key",):
            continue
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, path
            assert torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8)), path
        else:
            np.testing.assert_array_equal(a, b)
    return ta


@pytest.mark.parametrize("backend,dtype", [
    ("compact_fused", "float32"), ("pallas", "float32"),
    ("compact_fused", "bfloat16")])
def test_stacked_crash_resume_is_bitwise(backend, dtype, tmp_path):
    """Two layers online: a crash at update 3 of 4 with a checkpoint every
    2 resumes from 2 to the uncrashed run's carry, optimizer state and
    losses, bit for bit; the carry is checkpointed per layer.  (The
    offline path's crash and resume at two layers runs on the card, in
    chip_smoke.py.)"""
    argv = ["--arch", "egru-spiral", "--layers", "2", "--rtrl-backend",
            backend, "--sparsity", "0.8", "--device", "cpu", "--steps", "4",
            "--ckpt-every", "2", "--influence-dtype", dtype, "--online",
            "--update-every", "3"]
    out_a = TRAIN.main([*argv, "--fail-at", "3", "--ckpt-dir",
                        str(tmp_path / "a")])
    out_b = TRAIN.main([*argv, "--ckpt-dir", str(tmp_path / "b")])
    assert (out_a["restarts"], out_b["restarts"]) == (1, 0)
    assert [w["update"] for w in out_a["windows"]] == [3, 4]
    b_loss = {w["update"]: w["loss"] for w in out_b["windows"]}
    assert [w["loss"] for w in out_a["windows"]] == [b_loss[3], b_loss[4]]
    like = _ckpt_like([*argv, "--ckpt-dir", str(tmp_path / "like")])
    tree = _assert_checkpoints_bitwise(tmp_path / "a", tmp_path / "b", like)
    names = {leaf_name(p) for p, _ in tree_flatten_with_path(tree)}
    buf = "M" if backend == "pallas" else "vals"
    assert {f"carry__{buf}__0", f"carry__{buf}__1", "carry__a__0",
            "carry__a__1"} <= names
    assert tree["carry"][buf][0].dtype == (
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def test_offline_stacked_compact_fused_equals_compact(tmp_path):
    """The offline path at two layers: the fused engine's first step
    against the compact engine's, on the same params and batch."""
    firsts = {}
    for backend in ("compact", "compact_fused"):
        run = TRAIN.build_offline(TRAIN.parse_args(
            _argv(2, backend, tmp_path, online=False)))
        xs, ys = run["data_at"](0)
        loss, grads, stats = run["loss_and_grads"](run["params"], xs, ys)
        assert int(stats["overflow"].max()) == 0
        firsts[backend] = (float(loss), grads)
    (lc, gc), (lf, gf) = firsts["compact"], firsts["compact_fused"]
    assert lf == pytest.approx(lc, rel=REL)
    _assert_trees_close(gf, gc)


# ---------------------------------------------------------------------------
# a JAX-written two-layer carry checkpoint
# ---------------------------------------------------------------------------

class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def jax_stacked_run():
    """What the JAX launcher hands its OnlineTrainer for `--arch
    egru-spiral --layers 2 --online --rtrl-backend compact_fused
    --sparsity 0.8`."""
    from repro.launch import train as JTRAIN
    captured = {}

    def fake_trainer(ocfg, learner, opt, params, masks, stream, **kw):
        captured.update(learner=learner, opt=opt, params=params, masks=masks,
                        stream=stream)
        raise _Captured

    mp = pytest.MonkeyPatch()
    mp.setattr(JON, "OnlineTrainer", fake_trainer)
    mp.setattr(sys, "argv", ["train", "--arch", "egru-spiral", "--layers",
                             "2", "--online", "--rtrl-backend",
                             "compact_fused", "--sparsity", "0.8"])
    try:
        with pytest.raises(_Captured):
            JTRAIN.main()
    finally:
        mp.undo()
    return captured


def test_reference_stacked_carry_checkpoint_resumes_in_the_port(
        jax_stacked_run, tmp_path):
    """The JAX trainer's two-layer compact_fused checkpoint after 1 window
    loads into the port bit for bit (per-layer leaves carry__vals__0/1,
    carry__idx__0/1) and resumes to the JAX trainer's second window."""
    from repro.checkpoint import ckpt as JCK
    run = jax_stacked_run
    jt = JON.OnlineTrainer(
        JON.OnlineTrainerConfig(total_steps=16, update_every=8, ckpt_every=1,
                                ckpt_dir=str(tmp_path / "jax"), log_every=1),
        run["learner"], run["opt"], run["params"], run["masks"],
        run["stream"])
    jout = jt.run()
    shutil.copytree(tmp_path / "jax" / "step_00000001",
                    tmp_path / "port" / "step_00000001")
    masks = [masks_from_numpy(jax.tree.map(np.asarray, m), "cpu")
             for m in run["masks"]]
    params = params_from_numpy(jax.tree.map(np.asarray, run["params"]), "cpu")
    cfg = C.stacked_config(C.EGRUConfig(), 2)
    learner = make_learner(LearnerSpec(engine="stacked", cfg=cfg,
                                       backend="compact_fused"))
    opt = O.masked(O.make_optimizer("adamw", lr=cfg.lr),
                   {"layers": masks, "out": None})
    tr = ON.OnlineTrainer(
        ON.OnlineTrainerConfig(total_steps=16, update_every=8, ckpt_every=1,
                               ckpt_dir=str(tmp_path / "port"), log_every=1),
        learner, opt, params, masks, TRAIN.make_stream(cfg, 0), device="cpu")
    like = tr._ckpt_tree()
    tree, step = load_checkpoint(tmp_path / "port", like)
    jtree, jstep = JCK.load_checkpoint(tmp_path / "jax", jt._ckpt_tree(),
                                       step=1)
    assert step == jstep == 1
    ours = dict((leaf_name(p), x) for p, x in tree_flatten_with_path(tree))
    assert {"carry__vals__0", "carry__vals__1", "carry__idx__0",
            "carry__idx__1", "carry__a__1", "carry__beta_prev"} <= set(ours)
    for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        mine = ours[JCK._leaf_name(p)]
        mine = to_numpy(mine) if isinstance(mine, torch.Tensor) else mine
        np.testing.assert_array_equal(np.asarray(x), mine)
    assert tr.try_resume() and (tr.update, tr.step) == (1, 8)
    out = tr.run()
    assert [m["update"] for m in out["metrics"]] == [2]
    np.testing.assert_allclose(out["metrics"][0]["loss"],
                               jout["metrics"][1]["loss"], rtol=REL)
    _assert_trees_close(tr.learner.params_of(tr.carry),
                        run["learner"].params_of(jt.carry))
    assert len(out["row_stats"]["layers"]) == 2
