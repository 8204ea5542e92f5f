"""The port's online token-LM launcher (`--arch {egru,rglru,snn}-lm
--online`) held against the JAX launcher's run at `--smoke` (vocab 16,
width 32), on the params, masks, learner, optimizer and stream the JAX
launcher hands its OnlineTrainer.

Tolerances: first-window losses and gradients within 1e-5 of each leaf's
largest magnitude (float32 sums over 8 steps, associated differently by the
two libraries; the JAX egru-lm side runs its Pallas kernel in interpret
mode); trajectories over 3 updates only (the Heaviside gates of EGRU and
the SNN make long trajectories chaotic under round-off).  The stream is
array_equal; crash and resume inside the port is bitwise.
"""
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import online as JON
from repro_torch.checkpoint import load_checkpoint
from repro_torch.launch import train as TRAIN
from repro_torch.optim import optimizers as O
from repro_torch.runtime import online as ON
from repro_torch.tree import leaf_name, tree_flatten_with_path
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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want):
    got = jax.tree.leaves(to_numpy(got))
    want = jax.tree.leaves(_np(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(g, w, rtol=0, atol=REL * scale)


class _Captured(Exception):
    pass


_JAX_RUNS = {}


def _jax_run(arch, *extra):
    """What the JAX launcher hands its OnlineTrainer for `--arch ARCH
    --online --smoke *extra`: config, learner, optimizer, params, masks and
    stream (memoised: each run is built once a test process)."""
    key = (arch,) + extra
    if key not in _JAX_RUNS:
        from repro.launch import train as JTRAIN
        captured = {}

        def fake_trainer(ocfg, learner, opt, params, masks, stream, **kw):
            captured.update(ocfg=ocfg, learner=learner, opt=opt,
                            params=params, masks=masks, stream=stream)
            raise _Captured

        mp = pytest.MonkeyPatch()
        mp.setattr(JON, "OnlineTrainer", fake_trainer)
        mp.setattr(sys, "argv", ["train", "--arch", arch, "--online",
                                 "--smoke", "--seed", "0", *extra])
        try:
            with pytest.raises(_Captured):
                JTRAIN.main()
        finally:
            mp.undo()
        _JAX_RUNS[key] = captured
    return _JAX_RUNS[key]


def _argv(arch, *extra):
    return ["--arch", arch, "--online", "--smoke", "--device", "cpu",
            "--seed", "0", *extra]


def _port_masks(jrun):
    masks = _np(jrun["masks"])
    return None if masks is None else masks_from_numpy(masks, "cpu")


def _window(stream, start=0, k=8):
    xs, ys = zip(*(stream(start + t) for t in range(k)))
    return np.stack(xs), np.stack(ys)


@pytest.mark.parametrize("arch", ["egru-lm", "rglru-lm", "snn-lm"])
def test_lm_stream_array_equal(arch):
    jstream = _jax_run(arch)["stream"]
    stream = TRAIN.build_lm(TRAIN.parse_args(_argv(arch)))["stream"]
    for t in (0, 1, 63, 64, 65, 200, 3):
        (x, y), (jx, jy) = stream(t), jstream(t)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    other = TRAIN.build_lm(TRAIN.parse_args(_argv(arch)[:-1] + ["1"]))
    assert not np.array_equal(other["stream"](0)[1], stream(0)[1])


# (arch, port backend, sparsity); the JAX side of egru-lm runs 'pallas'
_FIRST_WINDOW = [("egru-lm", b, "0.8") for b in ("dense", "pallas", "compact",
                                                 "compact_fused")] + [
    ("egru-lm", "pallas", "0"), ("rglru-lm", None, "0"),
    ("rglru-lm", None, "0.5"), ("snn-lm", None, "0")]


@pytest.mark.parametrize("arch,backend,sparsity", _FIRST_WINDOW)
def test_lm_first_window_matches_reference(arch, backend, sparsity):
    """The port's learner of the launcher run, fed the JAX launcher's
    params, masks and stream: the first window's loss and gradients."""
    jextra = ("--sparsity", sparsity) + (
        ("--rtrl-backend", "pallas") if arch == "egru-lm" else ())
    jrun = _jax_run(arch, *jextra)
    key = ("first_window",) + (arch,) + jextra
    if key not in _JAX_RUNS:
        xs, ys = _window(jrun["stream"])
        jl = jrun["learner"]
        jc = jl.init(jrun["params"], jrun["masks"],
                     (jnp.asarray(xs[0]), jnp.asarray(ys[0])), t_total=8.0)
        _, jloss, jgrads, _ = JON.stream_grads(jl, jc, jnp.asarray(xs),
                                               jnp.asarray(ys))
        _JAX_RUNS[key] = (float(jloss), _np(jgrads), xs, ys)
    jloss, jgrads, xs, ys = _JAX_RUNS[key]
    extra = ["--sparsity", sparsity]
    if backend is not None:
        extra += ["--rtrl-backend", backend]
    run = TRAIN.build_lm(TRAIN.parse_args(_argv(arch, *extra)))
    learner = run["learner"]
    carry = learner.init(params_from_numpy(_np(jrun["params"]), "cpu"),
                         _port_masks(jrun),
                         (torch.from_numpy(xs[0]), torch.from_numpy(ys[0])),
                         t_total=8.0)
    _, loss, grads, stats = ON.stream_grads(learner, carry,
                                            torch.from_numpy(xs),
                                            torch.from_numpy(ys))
    assert float(loss) == pytest.approx(jloss, rel=REL)
    _assert_trees_close(grads, jgrads)
    if arch == "egru-lm" and backend in ("compact", "compact_fused"):
        assert int(stats["overflow"].max()) == 0


@pytest.mark.parametrize("arch,extra", [
    ("egru-lm", ("--rtrl-backend", "compact_fused", "--sparsity", "0.8")),
    ("egru-lm", ("--rtrl-backend", "pallas",)),
    ("rglru-lm", ("--sparsity", "0.5")), ("snn-lm", ())])
def test_lm_first_window_against_the_window_oracle(arch, extra):
    """The launcher run's own first window against BPTT through the same
    window (a label a step): exact engines within 1e-5 of each leaf's
    largest entry on the surviving parameters (their pruned gradients
    exactly 0), e-prop by cosine >= 0.9 on W and R with the readout's
    gradient exact."""
    from repro_torch.cells import resolve_cell
    from repro_torch.core import bptt as BP
    from repro_torch.tree import apply_mask_tree, tree_map
    run = TRAIN.build_lm(TRAIN.parse_args(_argv(arch, *extra)))
    xs, ys = (torch.from_numpy(a) for a in _window(run["stream"]))
    carry = run["learner"].init(run["params"], run["masks"], (xs[0], ys[0]),
                                t_total=8.0)
    _, loss, grads, _ = ON.stream_grads(run["learner"], carry, xs, ys)
    bloss, bgrads = BP.window_bptt_loss_and_grads(resolve_cell(run["cfg"]),
                                                  run["params"], xs, ys)
    assert float(loss) == pytest.approx(float(bloss), rel=REL)
    if arch == "snn-lm":
        cos = lambda a, b: float((a * b).sum() / (a.norm() * b.norm()))
        assert cos(grads["W"], bgrads["W"]) >= 0.9
        assert cos(grads["R"], bgrads["R"]) >= 0.9
        _assert_trees_close(grads["out"], to_numpy(bgrads["out"]))
        return
    if run["masks"] is not None:
        bgrads = apply_mask_tree(run["masks"], bgrads)
        live = apply_mask_tree(run["masks"], tree_map(torch.ones_like, grads))
        for g, m in zip(jax.tree.leaves(to_numpy(grads)),
                        jax.tree.leaves(to_numpy(live))):
            assert (g[m == 0] == 0).all()
    _assert_trees_close(grads, to_numpy(bgrads))


@pytest.mark.parametrize("arch,extra", [
    ("egru-lm", ("--rtrl-backend", "compact", "--sparsity", "0.8")),
    ("rglru-lm", ("--sparsity", "0.5")), ("snn-lm", ())])
def test_lm_online_trainer_matches_reference(arch, extra):
    """3 updates of k = 8 from the JAX launcher's params and masks: every
    window's loss, the sparsity stats and the final params."""
    jrun = _jax_run(arch, *extra)
    ocfg = JON.OnlineTrainerConfig(total_steps=24, update_every=8,
                                   ckpt_every=0, log_every=1)
    jtr = JON.OnlineTrainer(ocfg, jrun["learner"], jrun["opt"],
                            jrun["params"], jrun["masks"], jrun["stream"])
    jout = jtr.run()
    run = TRAIN.build_lm(TRAIN.parse_args(_argv(arch, *extra)))
    masks = _port_masks(jrun)
    opt = O.make_optimizer("adamw", lr=3e-3)
    if masks is not None:
        opt = O.masked(opt, {**masks, "out": None})
    tr = ON.OnlineTrainer(
        ON.OnlineTrainerConfig(total_steps=24, update_every=8, log_every=1),
        run["learner"], opt, params_from_numpy(_np(jrun["params"]), "cpu"),
        masks, run["stream"], device="cpu")
    out = tr.run()
    assert (out["updates"], out["final_step"]) == (3, 24)
    assert out["carry_bytes"] == jout["carry_bytes"]
    np.testing.assert_allclose([m["loss"] for m in out["metrics"]],
                               [m["loss"] for m in jout["metrics"]], rtol=REL)
    assert [sorted(m) for m in out["metrics"]] == \
        [sorted(m) for m in jout["metrics"]]
    for key in ("alpha", "beta"):
        if key in jout["metrics"][0]:
            np.testing.assert_allclose([m[key] for m in out["metrics"]],
                                       [m[key] for m in jout["metrics"]],
                                       rtol=1e-6)
    _assert_trees_close(run["learner"].params_of(tr.carry),
                        jrun["learner"].params_of(jtr.carry))


@pytest.mark.parametrize("arch,extra", [
    ("egru-lm", ("--rtrl-backend", "compact", "--sparsity", "0.8")),
    ("rglru-lm", ("--sparsity", "0.5")), ("snn-lm", ())])
def test_lm_checkpoint_has_the_reference_layout(arch, extra, tmp_path):
    """The port's checkpoint of an LM run lists the JAX trainer's leaf
    names, shapes and dtypes, in its order."""
    jrun = _jax_run(arch, *extra)
    like = JON.OnlineTrainer(
        JON.OnlineTrainerConfig(total_steps=8, update_every=8, ckpt_every=1,
                                ckpt_dir=str(tmp_path / "jax")),
        jrun["learner"], jrun["opt"], jrun["params"], jrun["masks"],
        jrun["stream"])._ckpt_tree()
    out = TRAIN.main(_argv(arch, *extra, "--steps", "1", "--ckpt-every", "1",
                           "--ckpt-dir", str(tmp_path / "port")))
    assert out["final_step"] == 8
    from repro.checkpoint import ckpt as JCK
    manifest = json.loads((tmp_path / "port" / "step_00000001" /
                           "manifest.json").read_text())
    jleaves = jax.tree_util.tree_flatten_with_path(like)[0]
    assert [(e["name"], tuple(e["shape"]), e["dtype"])
            for e in manifest["leaves"]] == \
        [(JCK._leaf_name(p), tuple(np.shape(x)), str(np.asarray(x).dtype))
         for p, x in jleaves]
    tree, step = JCK.load_checkpoint(tmp_path / "port", like)
    assert step == 1 and int(tree["pos"]) == 8


@pytest.mark.parametrize("arch,extra", [
    ("egru-lm", ("--rtrl-backend", "dense")),
    ("egru-lm", ("--rtrl-backend", "pallas", "--sparsity", "0.8")),
    ("egru-lm", ("--rtrl-backend", "compact", "--sparsity", "0.8")),
    ("egru-lm", ("--rtrl-backend", "compact_fused", "--sparsity", "0.8")),
    ("rglru-lm", ("--sparsity", "0.5")), ("snn-lm", ())])
def test_lm_launcher_runs_on_cpu(arch, extra, capsys):
    out = TRAIN.main(_argv(arch, *extra, "--steps", "3", "--ckpt-every",
                           "0"))
    s = out["summary"]
    assert (s["updates"], s["final_step"], s["restarts"]) == (3, 24, 0)
    assert (s["vocab"], s["width"], s["device"]) == (16, 32, "cpu")
    assert s["engine"] == TRAIN.LM_ARCHS[arch]
    assert all(math.isfinite(w["loss"]) for w in out["windows"])
    assert s["carry_bytes"] > 0
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(printed) == s
    if arch == "egru-lm":
        assert s["backend"] == extra[1] and s["overflow"] == 0


def test_lm_smoke_caps_and_defaults():
    full = TRAIN.build_lm(TRAIN.parse_args(["--arch", "rglru-lm", "--online",
                                            "--device", "cpu"]))
    assert (full["vocab"], full["width"], full["updates"]) == (64, 64, 20)
    assert full["cfg"].n == 64 and full["cfg"].n_in == 64
    smoke = TRAIN.build_lm(TRAIN.parse_args(_argv(
        "egru-lm", "--width", "16", "--steps", "30")))
    assert (smoke["vocab"], smoke["width"], smoke["updates"]) == (16, 16, 10)
    assert smoke["cfg"].n_hidden == 16 and smoke["cfg"].n_out == 16
    args = TRAIN.parse_args(["--arch", "snn-lm"])
    assert (args.vocab, args.width, args.lr, args.batch, args.seq) == \
        (64, 64, 3e-3, 4, 64)
    assert args.rtrl_backend == "dense"


@pytest.mark.parametrize("arch,extra", [
    ("egru-lm", ("--rtrl-backend", "compact_fused", "--sparsity", "0.8")),
    ("rglru-lm", ("--sparsity", "0.5")), ("snn-lm", ())])
def test_lm_crash_and_resume_is_bitwise(arch, extra, tmp_path):
    """A crash at update 3 (checkpoints every 2) against the same run
    without it: the windows after the resume and the final checkpoints
    (carry, optimizer state, stream position) bit for bit."""
    argv = _argv(arch, *extra, "--steps", "6", "--ckpt-every", "2")
    a = TRAIN.main([*argv, "--fail-at", "3", "--ckpt-dir",
                    str(tmp_path / "a")])
    b = TRAIN.main([*argv, "--ckpt-dir", str(tmp_path / "b")])
    assert (a["restarts"], b["restarts"]) == (1, 0)
    assert a["final_step"] == b["final_step"] == 48
    b_loss = {w["update"]: w["loss"] for w in b["windows"]}
    assert [w["update"] for w in a["windows"]] == [3, 4, 5, 6]
    assert all(w["loss"] == b_loss[w["update"]] for w in a["windows"])
    args = TRAIN.parse_args([*argv, "--ckpt-dir", str(tmp_path / "like")])
    like = TRAIN.online_trainers(args, TRAIN.build_lm(args))(1)._ckpt_tree()
    ta, sa = load_checkpoint(tmp_path / "a", like)
    tb, sb = load_checkpoint(tmp_path / "b", like)
    assert sa == sb == 6
    for (path, x), (_, y) in zip(tree_flatten_with_path(ta),
                                 tree_flatten_with_path(tb)):
        if path == ("key",):
            continue
        np.testing.assert_array_equal(
            to_numpy(x) if isinstance(x, torch.Tensor) else x,
            to_numpy(y) if isinstance(y, torch.Tensor) else y,
            err_msg=leaf_name(path))


# the packed fields a window event carries on each LM path (the rest pack
# NaN there and are dropped)
_LM_FIELDS = {
    "egru-lm": {"loss", "grad_norm", "act_sparsity", "bwd_sparsity",
                "overflow", "kb_min", "kb_mean", "kb_max", "clip_factor",
                "health"},
    "rglru-lm": {"loss", "grad_norm", "clip_factor", "health"},
    "snn-lm": {"loss", "grad_norm", "act_sparsity", "clip_factor", "health"},
}


@pytest.mark.parametrize("arch,extra", [
    ("egru-lm", ("--rtrl-backend", "compact_fused", "--sparsity", "0.8")),
    ("rglru-lm", ("--sparsity", "0.5")), ("snn-lm", ())])
def test_lm_metrics_dir_validates(arch, extra, tmp_path):
    from repro_torch.obs import read_events, validate as VAL
    d = tmp_path / "m"
    bare = TRAIN.main(_argv(arch, *extra, "--steps", "4", "--ckpt-every",
                            "0"))
    out = TRAIN.main(_argv(arch, *extra, "--steps", "4", "--ckpt-every", "0",
                           "--metrics-dir", str(d), "--trace"))
    assert VAL.main([str(d)]) == 0
    wins = [e for e in read_events(d / "events.jsonl")
            if e["kind"] == "window"]
    assert len(wins) == 4
    for w in wins:
        have = {f for f in _LM_FIELDS[arch]
                if isinstance(w.get(f), (int, float))}
        assert have == _LM_FIELDS[arch], sorted(_LM_FIELDS[arch] - have)
    # telemetry observes: the instrumented run is the bare run
    assert [w["loss"] for w in out["windows"]] == \
        [w["loss"] for w in bare["windows"]]
    man = json.loads((d / "manifest.json").read_text())
    assert man["config"]["engine"] == TRAIN.LM_ARCHS[arch]


@pytest.mark.parametrize("arch", ["egru-lm", "rglru-lm", "snn-lm"])
def test_lm_launcher_raises_without_cuda_unless_cpu_asked(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRAIN.main(["--arch", arch, "--online", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("extra,match", [
    (["--arch", "egru-lm", "--layers", "2"], "--layers"),
    (["--arch", "egru-lm", "--rewire", "set", "--sparsity", "0.8"],
     "--rewire"),
    (["--arch", "egru-lm", "--guard", "--guard-ring", "2"],
     "--guard, --guard-ring"),
    (["--arch", "egru-lm", "--inject-nan-at", "3"], "--inject-nan-at"),
    (["--arch", "egru-lm", "--influence-dtype", "bfloat16",
      "--rtrl-backend", "compact"], "--influence-dtype"),
    (["--arch", "egru-lm", "--col-compact", "off"], "--col-compact"),
    (["--arch", "rglru-lm", "--rtrl-backend", "pallas"], "--rtrl-backend"),
    (["--arch", "snn-lm", "--capacity", "0.5"], "--capacity"),
    (["--arch", "snn-lm", "--sparsity", "0.5"], "not wired for snn-lm"),
    (["--arch", "egru-spiral", "--vocab", "32"], "--vocab"),
    (["--arch", "egru-spiral", "--lr", "0.01", "--rtrl-backend", "compact"],
     "--lr")])
def test_lm_refuses_flags_it_does_not_read(extra, match, tmp_path,
                                           monkeypatch):
    """The reference's LM path ignores these flags silently; the port
    refuses each, before the metrics directory is made."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=match):
        TRAIN.main(["--online", "--device", "cpu", "--metrics-dir", "m",
                    *extra])
    assert list(tmp_path.iterdir()) == []


def test_lm_needs_online(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for arch in TRAIN.LM_ARCHS:
        with pytest.raises(SystemExit, match="pass --online"):
            TRAIN.main(["--arch", arch, "--device", "cpu", "--metrics-dir",
                        "m"])
    assert list(tmp_path.iterdir()) == []
