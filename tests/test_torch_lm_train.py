"""The port's LM training path held against the JAX package: the
optimizers (adamw, lion, adafactor, sgdm), the schedules, gradient
clipping and microbatch accumulation (`repro_torch.optim`), the train step
(`launch.steps.make_train_step` against the reference's jitted step),
RWKV6's `loss_fn`, and both launchers at `--smoke --device cpu` for every
ported LM arch, with crash and resume.

The same numpy inputs and the reference's own parameters
(`weights.params_from_numpy`) go to both packages.  Tolerances: 1e-6 of
each leaf's largest entry for the optimizers and schedules (the same
float32 formulas on the same inputs); 1e-5 for losses, and for the
decoders' gradient norms and gradients (float32 sums associated
differently).  Two places need more, each for a stated reason:

  * RWKV6's gradients and gradient norm: 2e-4 of each leaf's largest
    entry.  The smoke model's f32 gradients are ill-conditioned: the
    per-head group norm (eps 6.4e-4) divides by the spread of a head's
    WKV output, which is tiny at some positions, so each package's f32
    round-off in the forward moves its gradients by more than 1e-5.  The
    port's own gradients agree to 1e-5 across chunk lengths (the same
    math, another association).
  * Parameters after adamw steps: 1e-5 of each leaf's largest entry
    plus a tenth of the learning rate a step.  adamw moves an element by
    lr * m / (sqrt(v) + eps); where a gradient element is near eps
    (1e-8), f32 round-off in it changes that step by a fraction of lr.

Crash and resume inside the port is bitwise.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs import get_config as jget_config, smoke_config as jsmoke
from repro.configs.base import ShapeSuite
from repro.data.tokens import synthetic_token_batches as jbatches
from repro.launch import steps as JSTEPS
from repro.models import get_model as jget_model, rwkv as JR, transformer as JT
from repro.models.module import materialize as jmaterialize
from repro_torch import optim as O, weights as W
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve as SERVE, steps as STEPS, train as TRAIN
from repro_torch.models import rwkv as R, transformer as T

RWKV_GRAD_REL = 2e-4       # see the module docstring
LM = ["gemma2-2b", "qwen3-8b", "yi-6b", "minitron-8b", "internvl2-2b",
      "rwkv6-3b"]
# the MoE decoders and the Griffin RG-LRU LM
MOE_RGLRU = ["olmoe-1b-7b", "kimi-k2-1t-a32b", "recurrentgemma-9b"]


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _trees_close(got, want, rel, what=""):
    g = jax.tree.leaves(W.to_numpy(got))
    w = jax.tree.leaves(jax.tree.map(lambda x: np.asarray(x, np.float32), want))
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        _close(a, b, rel, what)


def _tree(seed):
    """A parameter-shaped tree: a stacked rank-3 leaf, a matrix, a vector."""
    rng = np.random.default_rng(seed)
    return {"units": {"w": rng.standard_normal((2, 3, 5)).astype(np.float32)},
            "emb": rng.standard_normal((6, 4)).astype(np.float32),
            "ln": rng.standard_normal((4,)).astype(np.float32)}


# ---------------------------------------------------------------------------
# optimizers, schedules, clipping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adamw", {"weight_decay": 0.1}),
    ("adamw", {"moment_dtype": "bfloat16"}),
    ("lion", {}), ("lion", {"weight_decay": 0.05}),
    ("adafactor", {}), ("adafactor", {"clip_threshold": 0.5}),
    ("sgdm", {}),
    ("adamw", {"schedule": ("cosine_warmup", 1e-2, 2, 6)}),
    ("lion", {"schedule": ("linear_warmup", 1e-3, 3)}),
    ("sgdm", {"schedule": ("constant", 5e-3)}),
])
def test_optimizers_equal_the_reference_over_3_steps(name, kw):
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if "moment_dtype" in kw:
        jkw["moment_dtype"] = jnp.bfloat16
        tkw["moment_dtype"] = torch.bfloat16
    if "schedule" in kw:
        sched, *a = kw["schedule"]
        del jkw["schedule"], tkw["schedule"]
        jkw["lr"], tkw["lr"] = getattr(JO, sched)(*a), getattr(O, sched)(*a)
    jopt, opt = getattr(JO, name)(**jkw), getattr(O, name)(**tkw)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = W.params_from_numpy(_tree(0), "cpu")
    js, ts = jopt.init(jp), opt.init(tp)
    for step in range(3):
        g = _tree(10 + step)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.int32(step))
        tp, ts = opt.update(W.params_from_numpy(g, "cpu"), ts, tp, step)
        _trees_close(tp, jp, 1e-6, f"{name} params, step {step}")
        _trees_close(ts, js, 1e-6, f"{name} state, step {step}")
    if name == "lion":
        assert all(m.dtype == torch.bfloat16
                   for m in jax.tree.leaves(ts["m"]))


def test_schedules_equal_the_reference():
    for name, a in (("constant", (3e-4,)), ("linear_warmup", (1e-3, 5)),
                    ("cosine_warmup", (1e-3, 4, 20)),
                    ("cosine_warmup", (2e-3, 3, 10, 0.0))):
        j, t = getattr(JO, name)(*a), getattr(O, name)(*a)
        for step in range(25):
            _close(t(step), j(jnp.int32(step)), 1e-6, f"{name} at {step}")


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_equals_the_reference(max_norm):
    g = _tree(3)
    jc, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tc, tn = O.clip_by_global_norm(W.params_from_numpy(g, "cpu"), max_norm)
    _close(tn, jn, 1e-6, "norm")
    _trees_close(tc, jc, 1e-6, "clipped")
    assert (float(tn) > max_norm) == (max_norm == 0.5)


@pytest.mark.parametrize("name", ["adamw", "lion", "adafactor", "sgdm"])
def test_the_in_place_update_is_bitwise_the_tree_update(name):
    """`launch.steps.update_in_place` (leaf by leaf, into the old buffers)
    against `opt.update` on the whole tree, over 3 steps."""
    opt = O.make_optimizer(name, lr=O.cosine_warmup(1e-2, 2, 5))
    tp = W.params_from_numpy(_tree(0), "cpu")
    ip = W.params_from_numpy(_tree(0), "cpu")
    ts, istate = opt.init(tp), opt.init(ip)
    for step in range(3):
        g = W.params_from_numpy(_tree(20 + step), "cpu")
        tp, ts = opt.update(g, ts, tp, step)
        STEPS.update_in_place(opt, g, istate, ip, step)
        for a, b in zip(jax.tree.leaves(W.to_numpy([tp, ts])),
                        jax.tree.leaves(W.to_numpy([ip, istate]))):
            assert np.array_equal(a, b)


def test_make_optimizer_names():
    for name in ("adamw", "lion", "adafactor", "sgdm"):
        assert isinstance(O.make_optimizer(name), O.Optimizer)
    with pytest.raises(ValueError):
        O.make_optimizer("rmsprop")
    with pytest.raises(NotImplementedError, match="adamw"):
        O.lion().slot_steps([0, 1], "cpu")


# ---------------------------------------------------------------------------
# microbatches, the train step, RWKV6's loss
# ---------------------------------------------------------------------------

def _models(arch, scan=False, **kw):
    jcfg = jsmoke(jget_config(arch)).replace(scan_layers=scan, **kw)
    cfg = smoke_config(get_config(arch)).replace(scan_layers=scan, **kw)
    jp = jmaterialize(jget_model(jcfg).specs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, W.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, B, S, step=0):
    extra = {"n_patches": cfg.n_patches} if cfg.n_patches else {}
    return next(jbatches(B, S, cfg.vocab_size, seed=1234 + step, **extra))


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("n_micro", [2, 4])
def test_microbatch_grads_equal_the_reference_and_the_full_batch(n_micro):
    jcfg, cfg, jp, tp = _models("yi-6b")
    b = _batch(cfg, 4, 16)
    jloss = lambda p, bb: JT.loss_fn(jcfg, p, bb)
    tloss = lambda p, bb: T.loss_fn(cfg, p, bb)
    jl, jg = jax.jit(functools.partial(JO.microbatch_grads, jloss,
                                       n_micro=n_micro))(
        jp, jax.tree.map(jnp.asarray, b))
    tl, tg = O.microbatch_grads(tloss, tp, _tb(b), n_micro)
    _close(tl, jl, 1e-5, "loss")
    _trees_close(tg, jg, 1e-5, "microbatch gradients")
    assert all(g.dtype == torch.float32 for g in jax.tree.leaves(tg))
    fl, fg = O.microbatch_grads(tloss, tp, _tb(b), 1)
    _close(tl, fl, 1e-5, "loss vs the full batch")
    _trees_close(tg, W.to_numpy(fg), 1e-5, "gradients vs the full batch")


def test_microbatch_grads_refuse_a_batch_that_does_not_split():
    """4 rows in 3 microbatches: the port refuses; the reference's slices
    of 4 // 3 rows take 3 rows and drop the fourth without a word."""
    jcfg, cfg, jp, tp = _models("yi-6b")
    b = _batch(cfg, 4, 8)
    with pytest.raises(ValueError, match="does not split"):
        O.microbatch_grads(lambda p, bb: T.loss_fn(cfg, p, bb), tp, _tb(b), 3)
    jl, _ = JO.microbatch_grads(lambda p, bb: JT.loss_fn(jcfg, p, bb), jp,
                                jax.tree.map(jnp.asarray, b), 3)
    three = {k: v[:3] for k, v in b.items()}
    tl, _ = O.microbatch_grads(lambda p, bb: T.loss_fn(cfg, p, bb), tp,
                               _tb(three), 3)
    _close(tl, jl, 1e-5, "the reference's loss is the first 3 rows'")


@pytest.mark.parametrize("arch,kw", [
    ("gemma2-2b", {"scan": True}), ("internvl2-2b", {}),
    ("rwkv6-3b", {"scan": True}),
    ("yi-6b", {"n_microbatches": 2, "optimizer": "lion"}),
    ("qwen3-8b", {"optimizer": "adafactor", "remat": "dots"}),
    ("olmoe-1b-7b", {"scan": True}), ("kimi-k2-1t-a32b", {}),   # lion
    ("recurrentgemma-9b", {"scan": True})])
def test_train_step_equals_the_references_jitted_step(arch, kw):
    kw = dict(kw)
    scan = kw.pop("scan", False)
    jcfg, cfg, jp, tp = _models(arch, scan, **kw)
    B, S = 4, 16
    # one CPU device, its axes Auto: the reference's `make_host_mesh` takes
    # this JAX's default Explicit axes, which its sharding constraints
    # refuse (ROADMAP Queue 3: `test_lm_substrate_end_to_end`)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    built = JSTEPS.make_train_step(jcfg, mesh, ShapeSuite("t", S, B, "train"))
    step = STEPS.make_train_step(cfg)
    jstate = jax.jit(JSTEPS.default_optimizer(jcfg).init)(jp)
    tstate = STEPS.default_optimizer(cfg).init(tp)
    gtol = RWKV_GRAD_REL if cfg.family == "rwkv6" else 1e-5
    for s in range(3):
        b = _batch(cfg, B, S, s)
        jp, jstate, jm = built.jitted(jp, jstate, jax.tree.map(jnp.asarray, b),
                                      jnp.int32(s))
        tp, tstate, tm = step(tp, tstate, _tb(b), s)
        _close(tm["loss"], jm["loss"], 1e-5, f"loss, step {s}")
        _close(tm["grad_norm"], jm["grad_norm"], gtol, f"grad norm, step {s}")
    lr = 3e-4                         # default_optimizer's
    for a, w in zip(jax.tree.leaves(W.to_numpy(tp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        err = float(np.abs(a - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()) + 0.1 * lr * 3, err


@pytest.mark.parametrize("scan", [False, True])
def test_rwkv_loss_and_gradients_equal_the_reference(scan):
    jcfg, cfg, jp, tp = _models("rwkv6-3b", scan)
    b = _batch(cfg, 2, 24)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, bb: JR.loss_fn(jcfg, p, bb)))(
        jp, jax.tree.map(jnp.asarray, b))
    tl, tg = O.microbatch_grads(lambda p, bb: R.loss_fn(cfg, p, bb), tp,
                                _tb(b), 1)
    _close(tl, jl, 1e-5, "loss")
    _trees_close(tg, jg, RWKV_GRAD_REL, "gradients")
    # the port's own gradients across chunk lengths: the same math
    _, t4 = O.microbatch_grads(lambda p, bb: R.loss_fn(
        cfg.replace(rwkv_chunk=4), p, bb), tp, _tb(b), 1)
    _trees_close(t4, W.to_numpy(tg), 1e-5, "chunk 4 vs chunk 8")


def test_rwkv_training_calls_the_plain_wkv_explicitly(monkeypatch):
    """loss_fn reaches wkv_reference by `plain=True`, never the kernel
    wrapper; prefill still goes through the wrapper."""
    from repro_torch.kernels import wkv as WK
    _, cfg, _, tp = _models("rwkv6-3b")
    seen = []
    real_ref = WK.wkv_reference
    monkeypatch.setattr(WK, "wkv", lambda *a, **k: seen.append("wkv")
                        or real_ref(*a, **k))
    monkeypatch.setattr(WK, "wkv_reference", lambda *a, **k: seen.append("ref")
                        or real_ref(*a, **k))
    R.loss_fn(cfg, tp, _tb(_batch(cfg, 1, 8)))
    assert seen == ["ref"] * cfg.n_layers
    seen.clear()
    R.prefill(cfg, tp, torch.zeros((1, 8), dtype=torch.long))
    assert seen == ["wkv"] * cfg.n_layers


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def _final_files(root, step):
    d = root / f"step_{step:08d}"
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.suffix == ".npy"}


@pytest.mark.parametrize("arch", LM + MOE_RGLRU)
def test_train_launcher_crash_and_resume_is_bitwise(arch, tmp_path):
    """--smoke --device cpu: a crash at step 3 (checkpoints every 2)
    against the same run without it, the final checkpoints bit for bit."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "5",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2"]
    a = TRAIN.main([*argv, "--fail-at", "3", "--ckpt-dir", str(tmp_path / "a")])
    b = TRAIN.main([*argv, "--ckpt-dir", str(tmp_path / "b")])
    assert (a["restarts"], b["restarts"]) == (1, 0)
    assert a["final_step"] == b["final_step"] == 5
    assert all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
               for s in b["steps"])
    fa, fb = _final_files(tmp_path / "a", 5), _final_files(tmp_path / "b", 5)
    assert fa.keys() == fb.keys() and len(fa) > 0
    assert all(fa[k] == fb[k] for k in fa)
    assert b["summary"]["arch"] == arch and b["summary"]["final_loss"] > 0


def test_train_launcher_first_steps_equal_the_reference_data(tmp_path):
    """The launcher's batches are the reference's `synthetic_token_batches`
    at seed 1234 + step, patch embeddings included."""
    run = TRAIN.build_model_lm(TRAIN.parse_args(
        ["--arch", "internvl2-2b", "--smoke", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)]))
    for s in (0, 3):
        got, want = run["data_at"](s), _batch(run["cfg"], 4, 64, s)
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k].numpy(), want[k])


def test_train_launcher_metrics_dir_validates(tmp_path):
    from repro_torch.obs import validate as VAL
    d = tmp_path / "m"
    out = TRAIN.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--ckpt-every", "0", "--ckpt-dir",
                      str(tmp_path / "ck"), "--metrics-dir", str(d),
                      "--trace"])
    assert VAL.main([str(d)]) == 0
    man = json.loads((d / "manifest.json").read_text())
    assert man["final"]["final_step"] == out["final_step"] == 2


@pytest.mark.parametrize("arch", LM[:-1])
def test_serve_launcher_runs_each_decoder(arch):
    out = SERVE.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "5", "--max-new", "6"])
    assert out["failed_requests"] == [] and out["summary"]["tokens"] == 30
    assert all(len(o) == 6 for o in out["outputs"])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-a32b",
                                  "whisper-large-v3", "recurrentgemma-9b"])
def test_both_launchers_refuse_what_is_not_ported(arch, tmp_path, monkeypatch):
    """whisper-large-v3 (the encoder-decoder) is refused by both launchers
    before anything is written; the MoE decoders and recurrentgemma-9b,
    ported, train and serve at --smoke (metrics directories validated)."""
    from repro_torch.obs import validate as VAL
    monkeypatch.chdir(tmp_path)
    if arch == "whisper-large-v3":
        with pytest.raises(SystemExit, match="item 14"):
            TRAIN.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--metrics-dir", "m"])
        with pytest.raises(NotImplementedError, match="item 14"):
            SERVE.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--metrics-dir", "m"])
        assert list(tmp_path.iterdir()) == []
        return
    out = TRAIN.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                      "3", "--batch", "2", "--seq", "16", "--ckpt-every", "0",
                      "--ckpt-dir", "ck", "--metrics-dir", "mt"])
    assert out["final_step"] == 3 and np.isfinite(out["summary"]["final_loss"])
    served = SERVE.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "5", "--max-new", "6",
                         "--metrics-dir", "ms"])
    assert served["failed_requests"] == [] and served["summary"]["tokens"] == 30
    assert VAL.main(["mt"]) == VAL.main(["ms"]) == 0


@pytest.mark.parametrize("extra", [
    ["--online"], ["--rtrl-backend", "compact"], ["--sparsity", "0.5"],
    ["--layers", "2"], ["--guard"], ["--rewire", "set"],
    ["--inject-nan-at", "3"], ["--vocab", "32"], ["--width", "32"],
    ["--lr", "0.1"], ["--update-every", "4"]])
def test_train_launcher_refuses_flags_the_lm_path_does_not_read(
        extra, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="not read by --arch yi-6b"):
        TRAIN.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                    "--metrics-dir", "m", *extra])
    assert list(tmp_path.iterdir()) == []


def test_train_launcher_raises_without_cuda_unless_cpu_asked(monkeypatch,
                                                             tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TRAIN.main(["--arch", "gemma2-2b", "--smoke", "--ckpt-dir",
                    str(tmp_path)])
