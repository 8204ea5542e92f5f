"""The port's learners, optimizer, online trainer and launcher held against
the JAX package on the same numpy params, masks and stream.

Tolerances: window gradients and losses agree to 1e-5 of each leaf's
largest magnitude (float32 sums over 8 steps, associated differently by
the two libraries); the optimizer's bias-correction scalars and the stream
agree exactly.  The Heaviside gate makes long trajectories chaotic under
round-off, so trajectories are compared over 3 updates only.
"""
import json
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cells as JC, learner as JL, sparse_rtrl as JSP
from repro.optim import optimizers as JO
from repro.runtime import online as JON
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import egru_spiral
from repro_torch.core import cells as C
from repro_torch.core.learner import LearnerSpec, make_learner, scan_learner
from repro_torch.launch import train as TRAIN
from repro_torch.optim import optimizers as O
from repro_torch.runtime import online as ON
from repro_torch.tree import leaf_name, tree_flatten_with_path
from repro_torch.weights import masks_from_numpy, params_from_numpy, to_numpy

REL = 1e-5


def _tree_np(t):
    return jax.tree.map(np.asarray, t)


def _assert_trees_close(got, want):
    got = jax.tree.leaves(to_numpy(got))
    want = jax.tree.leaves(_tree_np(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(g, w, rtol=0, atol=REL * scale)


def _spiral_setup(stacked, B=8, k=8, seed=0):
    """JAX-drawn params and masks (sparsity 0.8) of the spiral EGRU, as
    numpy; a window of k steps with per-example input scales (ragged
    activity)."""
    jcfg = JC.EGRUConfig(n_hidden=16, n_in=2, n_out=2, batch_size=B)
    cfg = C.EGRUConfig(n_hidden=16, n_in=2, n_out=2, batch_size=B)
    if stacked:
        jcfg, cfg = JC.stacked_config(jcfg, 1), C.stacked_config(cfg, 1)
        params = JC.init_stacked_params(jcfg, jax.random.key(seed))
        from repro.core import stacked_rtrl as JST
        masks = JST.make_stacked_masks(jcfg, jax.random.key(seed + 1), 0.8)
        params = JST.apply_stacked_masks(params, masks)
    else:
        params = JC.init_params(jcfg, jax.random.key(seed))
        masks = JSP.make_masks(jcfg, jax.random.key(seed + 1), 0.8)
        params = JSP.apply_masks(params, masks)
    rng = np.random.default_rng(seed)
    xs = (rng.normal(size=(k, B, 2))
          * np.linspace(0.5, 2.5, B)[None, :, None]).astype(np.float32)
    ys = np.broadcast_to(rng.integers(0, 2, B).astype(np.int32), (k, B))
    return jcfg, cfg, _tree_np(params), _tree_np(masks), xs, np.array(ys)


def _port_masks(masks_np):
    if isinstance(masks_np, list):
        return [masks_from_numpy(m, "cpu") for m in masks_np]
    return masks_from_numpy(masks_np, "cpu")


@pytest.mark.parametrize("engine,backend,dtype,col_compact", [
    (e, b, d, c) for e in ("sparse", "stacked")
    for b, d, c in (("compact", "float32", None),
                    ("compact_fused", "float32", None),
                    ("compact_fused", "bfloat16", None))
] + [("sparse", "compact", "float32", False)] + [
    (e, b, "float32", c) for e in ("sparse", "stacked")
    for b in ("dense", "pallas") for c in (None, False)])
def test_window_grads_match_reference(engine, backend, dtype, col_compact):
    stacked = engine == "stacked"
    jcfg, cfg, params, masks, xs, ys = _spiral_setup(stacked)
    jl = JL.make_learner(JL.LearnerSpec(
        engine=engine, cfg=jcfg, backend=backend, influence_dtype=dtype,
        col_compact=col_compact))
    jc = jl.init(jax.tree.map(jnp.asarray, params),
                 jax.tree.map(jnp.asarray, masks),
                 (jnp.asarray(xs[0]), jnp.asarray(ys[0])), t_total=8.0)
    jc, jloss, jgrads, jstats = JON.stream_grads(jl, jc, jnp.asarray(xs),
                                                 jnp.asarray(ys))
    tl = make_learner(LearnerSpec(engine=engine, cfg=cfg, backend=backend,
                                  influence_dtype=dtype,
                                  col_compact=col_compact))
    tc = tl.init(params_from_numpy(params, "cpu"), _port_masks(masks),
                 (torch.from_numpy(xs[0]), torch.from_numpy(ys[0])),
                 t_total=8.0)
    tc, tloss, tgrads, tstats = ON.stream_grads(tl, tc, torch.from_numpy(xs),
                                                torch.from_numpy(ys))
    assert float(tloss) == pytest.approx(float(jloss), rel=REL)
    if dtype == "float32":
        _assert_trees_close(tgrads, jgrads)
    else:   # bf16 carries round at the same points; bound by bf16 steps
        for g, w in zip(jax.tree.leaves(to_numpy(tgrads)),
                        jax.tree.leaves(_tree_np(jgrads))):
            scale = max(float(np.abs(w).max()), 1e-3)
            np.testing.assert_allclose(g, w, rtol=0, atol=2.0 ** -7 * scale)
    assert set(tstats) == set(jstats)
    if "overflow" in jstats:
        np.testing.assert_array_equal(to_numpy(tstats["overflow"]),
                                      np.asarray(jstats["overflow"]))
    for key in ("alpha", "beta", "m_row_density"):
        np.testing.assert_allclose(to_numpy(tstats[key]),
                                   np.asarray(jstats[key]), rtol=1e-6)
    if stacked:
        assert tuple(tstats["alpha_layers"].shape) == (8, 1)
    if backend.startswith("compact"):
        np.testing.assert_array_equal(to_numpy(tc["idx"]),
                                      np.asarray(jc["idx"]))
    else:                   # the carried influence itself, same shape
        _assert_trees_close(tc["M"], jc["M"])


def test_scan_learner_is_the_stream_path_bitwise():
    _, cfg, params, masks, xs, ys = _spiral_setup(False)
    spec = LearnerSpec(engine="sparse", cfg=cfg, backend="compact_fused",
                       per_step_grads=True)
    loss, grads, stats = scan_learner(
        make_learner(spec), params_from_numpy(params, "cpu"),
        _port_masks(masks), torch.from_numpy(xs), torch.from_numpy(ys[0]))
    tl = make_learner(spec)
    c = tl.init(params_from_numpy(params, "cpu"), _port_masks(masks),
                (torch.from_numpy(xs[0]), torch.from_numpy(ys[0])),
                t_total=8.0)
    summed = None
    for t in range(8):
        c, out = tl.step(c, torch.from_numpy(xs[t]), torch.from_numpy(ys[0]))
        summed = out.grads if summed is None else jax.tree.map(
            lambda a, b: a + b, summed, out.grads)
    assert float(loss) == float(c["loss"])
    for a, b in zip(jax.tree.leaves(to_numpy(grads)),
                    jax.tree.leaves(to_numpy(tl.grads(c)))):
        np.testing.assert_array_equal(a, b)
    _assert_trees_close(summed, to_numpy(grads))


def test_unported_engines_and_backends_raise():
    cfg = C.EGRUConfig()
    # every engine is ported: the scaled carry builds, and keeps the
    # reference's refusals (compact_fused cannot rewire, and always carries
    # the columns compact); the cell zoo's engines build
    from repro_torch.core import scaled_rtrl as SC
    from repro_torch.core.learner import _NOT_PORTED_ENGINES
    assert _NOT_PORTED_ENGINES == {}
    scfg = SC.ScaledRTRLConfig(n=16, n_in=4, n_out=2, batch=2)
    assert make_learner(LearnerSpec(engine="scaled", cfg=scfg)) \
        .spec.engine == "scaled"
    with pytest.raises(ValueError, match="rewirable=True"):
        make_learner(LearnerSpec(engine="scaled", cfg=scfg,
                                 backend="compact_fused", rewirable=True))
    sparams, smasks = SC.init_params(scfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    with pytest.raises(ValueError, match="column-compact"):
        make_learner(LearnerSpec(engine="scaled", cfg=scfg,
                                 backend="compact_fused", col_compact=False)) \
            .init(sparams, smasks, (torch.zeros(2, 4), torch.zeros(2)))
    from repro_torch.cells.rglru import RGLRUCellConfig
    from repro_torch.cells.snn import SNNConfig
    from repro_torch.core.diag_rtrl import DiagCellConfig
    for engine, zoo_cfg in (("diag", DiagCellConfig()),
                            ("diag_exact", RGLRUCellConfig()),
                            ("eprop", SNNConfig()), ("snap", cfg)):
        assert make_learner(LearnerSpec(engine=engine, cfg=zoo_cfg)) \
            .spec.engine == engine
    for backend in ("dense", "pallas"):     # ported: a bf16 carry is not
        with pytest.raises(ValueError, match="compact carry"):
            make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                     backend=backend,
                                     influence_dtype="bfloat16"))
    # rewire is ported on every backend but the fused one (the reference's
    # refusal: its gate segments are built from the init-time layout)
    with pytest.raises(ValueError, match="rewirable=True"):
        make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                 backend="compact_fused", rewirable=True))
    with pytest.raises(ValueError):
        make_learner(LearnerSpec(engine="nope", cfg=cfg))
    fused = make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                     backend="compact_fused",
                                     col_compact=False))
    p = C.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="column-compact"):
        fused.init(p, None, (torch.zeros(2, 2), torch.zeros(2)), 8.0)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_ipow1_bitwise_and_adamw_masked_match_reference():
    for b in (0.9, 0.95, 0.999):
        for s in (0, 1, 2, 7, 100, 12345):
            assert O._ipow1(b, s) == np.asarray(JO._ipow1(b, jnp.int32(s)))
    rng = np.random.default_rng(0)
    params = {"a": {"W": rng.normal(size=(3, 4)).astype(np.float32)},
              "layers": [{"b": rng.normal(size=(5,)).astype(np.float32)}],
              "out": {"W": rng.normal(size=(4, 2)).astype(np.float32)}}
    mask = {"a": {"W": (rng.random((3, 4)) > 0.5).astype(np.float32)},
            "layers": [{"b": np.ones(5, np.float32)}], "out": None}
    jopt = JO.masked(JO.adamw(5e-3), jax.tree.map(jnp.asarray, mask))
    topt = O.masked(O.make_optimizer("adamw", lr=5e-3),
                    masks_from_numpy(mask, "cpu"))
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                         params)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.int32(step))
        tp, ts = topt.update(params_from_numpy(g, "cpu"), ts, tp, step)
    _assert_trees_close(tp, jp)
    _assert_trees_close(ts, js)
    assert (to_numpy(tp)["a"]["W"][mask["a"]["W"] == 0] == 0).all()
    # every name the reference accepts is ported; others are refused
    assert isinstance(O.make_optimizer("lion"), O.Optimizer)
    with pytest.raises(ValueError):
        O.make_optimizer("rmsprop")


# ---------------------------------------------------------------------------
# the launcher and the online trainer
# ---------------------------------------------------------------------------

class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def jax_launcher_run():
    """What the JAX launcher hands its OnlineTrainer for `--arch egru-spiral
    --online --rtrl-backend compact_fused --sparsity 0.8`: the stream, the
    params, the masks, the learner and the optimizer."""
    from repro.launch import train as JTRAIN
    captured = {}

    def fake_trainer(ocfg, learner, opt, params, masks, stream, **kw):
        captured.update(ocfg=ocfg, learner=learner, opt=opt, params=params,
                        masks=masks, stream=stream)
        raise _Captured

    argv = ["train", "--arch", "egru-spiral", "--online", "--rtrl-backend",
            "compact_fused", "--sparsity", "0.8", "--seed", "0"]
    mp = pytest.MonkeyPatch()
    mp.setattr(JON, "OnlineTrainer", fake_trainer)
    mp.setattr(sys, "argv", argv)
    try:
        with pytest.raises(_Captured):
            JTRAIN.main()
    finally:
        mp.undo()
    return captured


def test_launcher_stream_array_equal(jax_launcher_run):
    jstream = jax_launcher_run["stream"]
    stream = TRAIN.make_stream(C.stacked_config(C.EGRUConfig(), 1), seed=0)
    for t in (0, 1, 16, 17, 40, 1000):
        x, y = stream(t)
        jx, jy = jstream(t)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    other = TRAIN.make_stream(C.stacked_config(C.EGRUConfig(), 1), seed=1)
    assert not np.array_equal(other(0)[0], stream(0)[0])


def test_online_trainer_losses_match_reference(jax_launcher_run):
    """3 updates of k=8 from the JAX launcher's params and masks."""
    run = jax_launcher_run
    ocfg = JON.OnlineTrainerConfig(total_steps=24, update_every=8,
                                   ckpt_every=0, log_every=1)
    jtr = JON.OnlineTrainer(ocfg, run["learner"], run["opt"], run["params"],
                            run["masks"], run["stream"])
    jout = jtr.run()
    masks = _port_masks(_tree_np(run["masks"]))
    params = params_from_numpy(_tree_np(run["params"]), "cpu")
    cfg = C.stacked_config(C.EGRUConfig(), 1)
    learner = make_learner(LearnerSpec(engine="stacked", cfg=cfg,
                                       backend="compact_fused"))
    opt = O.masked(O.make_optimizer("adamw", lr=cfg.lr),
                   {"layers": masks, "out": None})
    tr = ON.OnlineTrainer(
        ON.OnlineTrainerConfig(total_steps=24, update_every=8, log_every=1),
        learner, opt, params, masks, TRAIN.make_stream(cfg, 0), device="cpu")
    out = tr.run()
    assert (out["updates"], out["final_step"]) == (3, 24)
    assert out["carry_bytes"] == jout["carry_bytes"]
    jl = [m["loss"] for m in jout["metrics"]]
    tl = [m["loss"] for m in out["metrics"]]
    np.testing.assert_allclose(tl, jl, rtol=REL)
    assert all(m["overflow"] == 0 for m in out["metrics"])
    for key in ("alpha", "beta"):
        np.testing.assert_allclose([m[key] for m in out["metrics"]],
                                   [m[key] for m in jout["metrics"]],
                                   rtol=1e-6)
    _assert_trees_close(learner.params_of(tr.carry),
                        run["learner"].params_of(jtr.carry))


def test_launcher_runs_on_cpu_when_asked(capsys):
    out = TRAIN.main(["--arch", "egru-spiral", "--online", "--rtrl-backend",
                      "compact_fused", "--sparsity", "0.8", "--device", "cpu",
                      "--smoke", "--steps", "20", "--update-every", "2",
                      "--ckpt-every", "0"])
    s = out["summary"]
    assert (s["updates"], s["final_step"]) == (12, 24)   # --smoke caps at 12
    assert np.isfinite([s["first_loss"], s["final_loss"]]).all()
    assert s["overflow"] == 0 and s["device"] == "cpu"
    assert '"backend": "compact_fused"' in capsys.readouterr().out


def test_launcher_raises_without_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRAIN.main(["--arch", "egru-spiral", "--online", "--sparsity", "0.8",
                    "--steps", "1"])


@pytest.mark.parametrize("extra", [
    # the LM archs are ported: the flags their path does not read (the
    # reference ignores --guard, --rewire and --sparsity for snn-lm refuses)
    # are refused beside them, and every refusal comes before the metrics
    # directory is made
    ["--guard", "--metrics-dir", "m", "--arch", "egru-lm"],
    ["--rewire", "rigl", "--sparsity", "0.8", "--metrics-dir", "m",
     "--arch", "rglru-lm"],
    ["--metrics-dir", "m", "--trace", "--arch", "snn-lm", "--sparsity",
     "0.5"],
    # yi-6b is ported: the flags its path does not read are refused
    ["--rewire", "set", "--rtrl-backend", "dense", "--arch", "yi-6b"],
    # olmoe-1b-7b and whisper-large-v3 are ported and train offline:
    # --online is refused beside them
    ["--arch", "olmoe-1b-7b"], ["--arch", "whisper-large-v3"]])
def test_launcher_rejects_later_slices(extra, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit,
                       match="not ported yet|not read by|not wired for"):
        TRAIN.main(["--arch", "egru-spiral", "--online", "--device", "cpu",
                    *extra])
    assert list(tmp_path.iterdir()) == []


def _first_window(argv):
    """Loss and gradients of a launcher run's first window (k=8), with the
    run's own params, masks and stream."""
    run = TRAIN.build_online(TRAIN.parse_args(argv))
    xs, ys = zip(*(run["stream"](t) for t in range(8)))
    xs, ys = torch.from_numpy(np.stack(xs)), torch.from_numpy(np.stack(ys))
    carry = run["learner"].init(run["params"], run["masks"], (xs[0], ys[0]),
                                t_total=8.0)
    carry, loss, grads, _ = ON.stream_grads(run["learner"], carry, xs, ys)
    return float(loss), grads, carry


_CPU_ARGV = ["--arch", "egru-spiral", "--online", "--sparsity", "0.8",
             "--device", "cpu"]


@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_launcher_pallas_and_dense_run_and_match_compact(backend, capsys):
    out = TRAIN.main([*_CPU_ARGV, "--rtrl-backend", backend, "--smoke",
                      "--steps", "3", "--ckpt-every", "0"])
    s = out["summary"]
    assert (s["backend"], s["updates"], s["final_step"]) == (backend, 3, 24)
    assert np.isfinite([w["loss"] for w in out["windows"]]).all()
    assert s["overflow"] == 0
    printed = capsys.readouterr().out
    assert ("col-compact carry ON" in printed) == (backend == "pallas")
    lb, gb, _ = _first_window([*_CPU_ARGV, "--rtrl-backend", backend])
    lc, gc, _ = _first_window([*_CPU_ARGV, "--rtrl-backend", "compact"])
    assert lb == pytest.approx(lc, rel=REL)
    _assert_trees_close(gb, to_numpy(gc))


def test_launcher_default_backend_is_dense():
    assert TRAIN.parse_args([]).rtrl_backend == "dense"
    assert TRAIN.parse_args([]).col_compact == "auto"
    run = TRAIN.build_online(TRAIN.parse_args(_CPU_ARGV))
    assert run["learner"].spec.backend == "dense"


def test_launcher_col_compact_off_with_compact_fused_exits():
    with pytest.raises(SystemExit, match="--col-compact off conflicts with "
                       "--rtrl-backend compact_fused"):
        TRAIN.main([*_CPU_ARGV, "--rtrl-backend", "compact_fused",
                    "--col-compact", "off"])


def test_launcher_col_compact_off_pallas_carries_full_width(capsys):
    _, g_off, c_off = _first_window([*_CPU_ARGV, "--rtrl-backend", "pallas",
                                     "--col-compact", "off"])
    assert "col-compact carry OFF" in capsys.readouterr().out
    assert tuple(c_off["M"].shape) == (32, 16, 1024)
    _, g_on, c_on = _first_window([*_CPU_ARGV, "--rtrl-backend", "pallas"])
    assert tuple(c_on["M"].shape) == (32, 16, 256)
    _assert_trees_close(g_off, to_numpy(g_on))


# ---------------------------------------------------------------------------
# checkpoint, resume, restart and the offline trainer
# ---------------------------------------------------------------------------

def _ckpt_like(argv):
    """The checkpoint tree of a launcher run's trainer (the `tree_like` of
    its checkpoints)."""
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
            a, b = a.reshape(-1).view(torch.uint8), b.reshape(-1).view(
                torch.uint8)
            assert torch.equal(a, b), path
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["--online", "offline"])
@pytest.mark.parametrize("backend", ["dense", "pallas", "compact",
                                     "compact_fused"])
def test_launcher_crash_and_restart_runs(mode, backend, tmp_path, capsys):
    """--ckpt-every 5 --fail-at 7: one restart from the checkpoint of update
    (online) or step (offline) 5, then the run ends; --metrics appends the
    logged records."""
    argv = ["--arch", "egru-spiral", "--rtrl-backend", backend, "--sparsity",
            "0.8", "--device", "cpu", "--steps", "10", "--ckpt-every", "5",
            "--fail-at", "7", "--ckpt-dir", str(tmp_path / "ck"),
            "--metrics", str(tmp_path / "m.jsonl")]
    if mode == "--online":
        argv += ["--online", "--update-every", "2"]
    out = TRAIN.main(argv)
    s = out["summary"]
    assert s["restarts"] == 1 and s["backend"] == backend
    assert s["mode"] == ("online" if mode == "--online" else "offline")
    assert s["final_step"] == (20 if mode == "--online" else 10)
    assert np.isfinite([s["first_loss"], s["final_loss"]]).all()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == s
    done = [r for r in out["windows" if mode == "--online" else "steps"]]
    assert len(done) == 5                  # updates or steps 6..10
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == \
        ["step_00000005", "step_00000010"]
    recs = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text()
            .splitlines()]
    assert recs and all(np.isfinite(r["loss"]) for r in recs)


@pytest.mark.parametrize("backend,dtype", [
    ("dense", "float32"), ("pallas", "float32"), ("compact", "float32"),
    ("compact_fused", "float32"), ("compact_fused", "bfloat16")])
def test_online_crash_resume_is_bitwise(backend, dtype, tmp_path):
    """A crash at update 7 of 10 (mid-sequence) with a checkpoint every 2
    updates resumes from update 6 to the uncrashed run's carry, optimizer
    state and window losses, bit for bit."""
    argv = ["--arch", "egru-spiral", "--online", "--rtrl-backend", backend,
            "--sparsity", "0.8", "--device", "cpu", "--update-every", "3",
            "--steps", "10", "--ckpt-every", "2", "--influence-dtype", dtype]
    out_a = TRAIN.main([*argv, "--fail-at", "7", "--ckpt-dir",
                        str(tmp_path / "a")])
    out_b = TRAIN.main([*argv, "--ckpt-dir", str(tmp_path / "b")])
    assert (out_a["restarts"], out_b["restarts"]) == (1, 0)
    assert out_a["final_step"] == out_b["final_step"] == 30
    assert [w["update"] for w in out_a["windows"]] == [7, 8, 9, 10]
    b_loss = {w["update"]: w["loss"] for w in out_b["windows"]}
    assert [w["loss"] for w in out_a["windows"]] == \
        [b_loss[u] for u in (7, 8, 9, 10)]
    like = _ckpt_like([*argv, "--ckpt-dir", str(tmp_path / "like")])
    _assert_checkpoints_bitwise(tmp_path / "a", tmp_path / "b", like)
    if dtype == "bfloat16":
        assert like["carry"]["vals"].dtype == torch.bfloat16
        assert out_a["row_stats"]["influence_dtype"] == "bfloat16"


def test_online_carry_bytes_are_o1_in_stream_length(tmp_path):
    """Byte-identical carry after 2 and after 10 updates."""
    sizes = {}
    for steps in (2, 10):
        out = TRAIN.main(["--arch", "egru-spiral", "--online",
                          "--rtrl-backend", "compact_fused", "--sparsity",
                          "0.8", "--device", "cpu", "--update-every", "3",
                          "--steps", str(steps), "--ckpt-every", "0"])
        assert out["updates"] == steps
        assert out["carry_live_bytes"] == out["carry_bytes"]
        sizes[steps] = out["carry_bytes"]
    assert sizes[2] == sizes[10]


def test_online_straggler_counter(tmp_path):
    """The first window seeds the EMA; with factor 0 every later window
    counts as a straggler."""
    args = TRAIN.parse_args(["--arch", "egru-spiral", "--online",
                             "--rtrl-backend", "compact", "--sparsity",
                             "0.8", "--device", "cpu", "--steps", "4",
                             "--update-every", "2", "--ckpt-every", "0"])
    tr = TRAIN.online_trainers(args, TRAIN.build_online(args))(0)
    tr.cfg.straggler_factor = 0.0
    out = tr.run()
    assert out["updates"] == 4 and out["stragglers"] == 3


def test_default_ckpt_dir_is_the_ports_own():
    args = TRAIN.parse_args([])
    assert args.ckpt_every == 10
    assert args.ckpt_dir != "/tmp/repro_ckpt"
    assert args.ckpt_dir.endswith("repro_torch_ckpt")


@pytest.mark.parametrize("mode", ["--online", "offline"])
def test_rerun_into_the_same_directory_resumes_at_its_end(mode, tmp_path,
                                                          capsys):
    argv = ["--arch", "egru-spiral", "--rtrl-backend", "compact",
            "--sparsity", "0.8", "--device", "cpu", "--steps", "3",
            "--ckpt-dir", str(tmp_path)]
    if mode == "--online":
        argv += ["--online", "--update-every", "2"]
    first = TRAIN.main(argv)
    again = TRAIN.main(argv)
    assert again["final_step"] == first["final_step"] > 0
    assert again["restarts"] == 0
    assert again["windows" if mode == "--online" else "steps"] == []
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s == again["summary"] and "first_loss" not in s
    assert s["final_step"] == first["final_step"]


def _port_online_trainer(jrun, root, total_steps, ckpt_every):
    """The port's OnlineTrainer on the JAX launcher's params and masks."""
    masks = _port_masks(_tree_np(jrun["masks"]))
    params = params_from_numpy(_tree_np(jrun["params"]), "cpu")
    cfg = C.stacked_config(C.EGRUConfig(), 1)
    learner = make_learner(LearnerSpec(engine="stacked", cfg=cfg,
                                       backend="compact_fused"))
    opt = O.masked(O.make_optimizer("adamw", lr=cfg.lr),
                   {"layers": masks, "out": None})
    return ON.OnlineTrainer(
        ON.OnlineTrainerConfig(total_steps=total_steps, update_every=8,
                               ckpt_every=ckpt_every, ckpt_dir=str(root),
                               log_every=1),
        learner, opt, params, masks, TRAIN.make_stream(cfg, 0), device="cpu")


def _jax_online_trainer(jrun, root, total_steps):
    return JON.OnlineTrainer(
        JON.OnlineTrainerConfig(total_steps=total_steps, update_every=8,
                                ckpt_every=1, ckpt_dir=str(root),
                                log_every=1),
        jrun["learner"], jrun["opt"], jrun["params"], jrun["masks"],
        jrun["stream"])


def test_reference_carry_checkpoint_resumes_in_the_port(jax_launcher_run,
                                                        tmp_path):
    """The JAX trainer's f32 compact_fused checkpoint after 2 windows
    resumes in the port, whose third window matches the JAX trainer's
    third window (3 JAX windows in all, one trainer)."""
    run = jax_launcher_run
    jt = _jax_online_trainer(run, tmp_path / "jax", 24)
    jout = jt.run()
    shutil.copytree(tmp_path / "jax" / "step_00000002",
                    tmp_path / "port" / "step_00000002")
    tr = _port_online_trainer(run, tmp_path / "port", 24, 1)
    assert tr.try_resume()
    assert (tr.update, tr.step) == (2, 16)
    out = tr.run()
    assert [m["update"] for m in out["metrics"]] == [3]
    assert jout["metrics"][2]["update"] == 3
    np.testing.assert_allclose(out["metrics"][0]["loss"],
                               jout["metrics"][2]["loss"], rtol=REL)
    _assert_trees_close(tr.learner.params_of(tr.carry),
                        run["learner"].params_of(jt.carry))


def test_port_carry_checkpoint_loads_in_the_reference(jax_launcher_run,
                                                      tmp_path):
    """The port's f32 checkpoint after one window loads through the JAX
    package's load_checkpoint, with its leaf names, shapes and dtypes."""
    run = jax_launcher_run
    tr = _port_online_trainer(run, tmp_path / "port", 8, 1)
    tr.run()
    like = _jax_online_trainer(run, tmp_path / "jax", 8)._ckpt_tree()
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
    ours = dict((leaf_name(p), x) for p, x in
                tree_flatten_with_path(tr._ckpt_tree()))
    for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        mine = ours[JCK._leaf_name(p)]
        mine = to_numpy(mine) if isinstance(mine, torch.Tensor) else mine
        np.testing.assert_array_equal(np.asarray(x), mine)


@pytest.fixture(scope="module")
def jax_offline_run():
    """What the JAX launcher hands its offline Trainer for `--arch
    egru-spiral --rtrl-backend compact --sparsity 0.8`: params, opt state
    and the step-keyed batches."""
    from repro.launch import train as JTRAIN
    captured = {}

    def fake_trainer(tcfg, step_fn, params, opt_state, data_at):
        captured.update(tcfg=tcfg, params=params, opt_state=opt_state,
                        data_at=data_at)
        raise _Captured

    argv = ["train", "--arch", "egru-spiral", "--rtrl-backend", "compact",
            "--sparsity", "0.8", "--seed", "0"]
    mp = pytest.MonkeyPatch()
    mp.setattr(JTRAIN, "Trainer", fake_trainer)
    mp.setattr(sys, "argv", argv)
    try:
        with pytest.raises(_Captured):
            JTRAIN.main()
    finally:
        mp.undo()
    return captured


def test_offline_batches_array_equal(jax_offline_run):
    cfg = egru_spiral.stacked(1)
    batches = TRAIN.make_offline_data(cfg)
    run = TRAIN.build_offline(TRAIN.parse_args(
        ["--rtrl-backend", "compact", "--sparsity", "0.8", "--device", "cpu",
         "--seed", "5"]))                 # the batches ignore --seed
    for step in (0, 1, 7, 1699):
        jx, jy = jax_offline_run["data_at"](step)
        x, y = batches(step)
        assert x.shape == (17, 32, 2) and y.shape == (32,)
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(y, np.asarray(jy))
        tx, ty = run["data_at"](step)
        np.testing.assert_array_equal(tx.numpy(), x)
        np.testing.assert_array_equal(ty.numpy(), y)


def _port_offline_first_step(backend, jmasks, jparams, jbatch):
    cfg = egru_spiral.stacked(1)
    masks = _port_masks(_tree_np(jmasks))
    opt = O.masked(O.make_optimizer("adamw", lr=cfg.lr),
                   {"layers": masks, "out": None})
    args = TRAIN.parse_args(["--rtrl-backend", backend, "--sparsity", "0.8",
                             "--device", "cpu"])
    loss_and_grads, step_fn = TRAIN.offline_fns(args, cfg, masks, opt,
                                                col_compact=True)
    params = params_from_numpy(_tree_np(jparams), "cpu")
    xs, ys = (torch.from_numpy(np.array(a)) for a in jbatch)
    loss, grads, stats = loss_and_grads(params, xs, ys)
    p1, _, m = step_fn(params, opt.init(params), (xs, ys), 0)
    assert float(m["loss"]) == float(loss)
    assert tuple(stats["alpha_layers"].shape) == (17, 1)
    return float(loss), grads, p1


@pytest.mark.parametrize("backend", ["compact", "pallas"])
def test_offline_first_step_matches_reference(jax_offline_run,
                                              jax_launcher_run, backend):
    """The port's offline step (`stacked_rtrl_loss_and_grads` + masked
    adamw) against the JAX package's on the same params, masks and batch
    (the JAX side on its compact backend: every backend is exact)."""
    from repro.configs import egru_spiral as JES
    from repro.core import stacked_rtrl as JST
    run = jax_offline_run
    jmasks = jax_launcher_run["masks"]
    jbatch = run["data_at"](0)
    jloss, jgrads, _ = JST.stacked_rtrl_loss_and_grads(
        JES.stacked(1), run["params"], *jbatch, jmasks, backend="compact",
        col_compact=True)
    jp1, _ = jax_launcher_run["opt"].update(jgrads, run["opt_state"],
                                            run["params"], jnp.int32(0))
    loss, grads, p1 = _port_offline_first_step(backend, jmasks,
                                               run["params"], jbatch)
    assert loss == pytest.approx(float(jloss), rel=REL)
    _assert_trees_close(grads, jgrads)
    _assert_trees_close(p1, jp1)


def test_offline_compact_fused_equals_compact(jax_offline_run,
                                              jax_launcher_run):
    """Offline compact_fused runs in the port (eager build) and equals its
    offline compact."""
    run = jax_offline_run
    args = (jax_launcher_run["masks"], run["params"], run["data_at"](0))
    lf, gf, pf = _port_offline_first_step("compact_fused", *args)
    lc, gc, pc = _port_offline_first_step("compact", *args)
    assert lf == pytest.approx(lc, rel=REL)
    _assert_trees_close(gf, to_numpy(gc))
    _assert_trees_close(pf, to_numpy(pc))
