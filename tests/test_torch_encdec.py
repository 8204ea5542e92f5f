"""The port's encoder-decoder (`repro_torch.models.encdec`, whisper's
backbone; `models.attention`'s cross-attention; `configs.whisper_large_v3`)
held against the JAX package on the same inputs: numpy arrays made from a
seed, and the reference's own parameters (`materialize` at a key) moved to
the port through `weights.params_from_numpy`.  f32 smoke configs, with the
layers stacked (`scan_layers`) and listed.

Tolerances: 1e-5 of the largest magnitude for attention, the encoder
output, logits and the loss; 1e-5 of each leaf's largest entry for
gradients; prefill then 16 decode steps within 1e-4 of the largest logit
of the port's own full forward (the reference's serving path has two
faults, ROADMAP Queue 3 faults 10 and 11, recorded below, so that case is
not held against it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, smoke_config as jsmoke
from repro.models import attention as JA, encdec as JE
from repro.models.module import count_params as jcount
from repro.models.module import materialize as jmaterialize
from repro_torch import weights as W
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import train as TRAIN
from repro_torch.models import attention as A, encdec as E, get_model
from repro_torch.models.module import ParamSpec, count_params
from repro_torch.optim.grad import microbatch_grads
from repro_torch.tree import tree_leaves, tree_map

ARCH = "whisper-large-v3"
REL = 1e-5


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _models(scan=False):
    """(reference cfg, port cfg, reference params, port params), f32 smoke
    (2 + 2 layers, d 64, 32 frames)."""
    jcfg = jsmoke(jget_config(ARCH)).replace(scan_layers=scan)
    cfg = smoke_config(get_config(ARCH)).replace(scan_layers=scan)
    jp = jmaterialize(JE.encdec_specs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, W.params_from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu")


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    frames = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
              * 0.02).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy(),
            "frames": frames}


def _tb(b):
    return {k: _t(v).long() if v.dtype.kind == "i" else _t(v)
            for k, v in b.items()}


# ---------------------------------------------------------------------------
# config and specs
# ---------------------------------------------------------------------------

def test_config_and_full_size_specs_equal_the_reference():
    want, got = jget_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert str(b) == f"torch.{jnp.dtype(a).name}", f.name
        else:
            assert a == b, f.name
    api = get_model(got)
    assert api.family == "encdec" and api.prefill is E.prefill
    specs = E.encdec_specs(got)
    assert count_params(specs) == jcount(JE.encdec_specs(want)) \
        == 1_600_990_720
    # the full size on the meta device: every leaf's shape and dtype
    meta = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)
    assert sum(t.numel() for t in tree_leaves(meta)) == 1_600_990_720
    assert meta["enc"]["attn"]["wq"].shape == (32, 1280, 1280)
    assert meta["dec"]["cross_attn"]["wk"].dtype == torch.bfloat16
    assert "q_norm" not in specs["dec"]["cross_attn"]


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("scan", [False, True])
def test_spec_tree_equals_the_reference(scan, qk_norm):
    """Same keys, shapes and dtypes, stacked and listed; the cross
    attention drops qk-norm, as in the reference."""
    jcfg = jsmoke(jget_config(ARCH)).replace(scan_layers=scan,
                                             qk_norm=qk_norm)
    cfg = smoke_config(get_config(ARCH)).replace(scan_layers=scan,
                                                 qk_norm=qk_norm)
    jspecs, specs = JE.encdec_specs(jcfg), E.encdec_specs(cfg)
    jl = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "init"))[0]
    from repro_torch.tree import tree_flatten_with_path
    tl = tree_flatten_with_path(specs)
    assert len(jl) == len(tl)
    for (jp, js), (tp, ts) in zip(jl, tl):
        jkeys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in jp)
        assert jkeys == tuple(tp)
        assert isinstance(ts, ParamSpec) and tuple(ts.shape) == tuple(js.shape)
        assert str(ts.dtype) == f"torch.{jnp.dtype(js.dtype).name}"
    cross = specs["dec"]["cross_attn"] if scan else specs["dec"][0]["cross_attn"]
    selfa = specs["dec"]["self_attn"] if scan else specs["dec"][0]["self_attn"]
    assert "q_norm" not in cross and ("q_norm" in selfa) == qk_norm


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def test_cross_attention_and_its_decode_form_equal_the_reference():
    """Queries over 32 frames' keys in 16-key blocks; the decode form over
    the K/V projected once."""
    jcfg, cfg, jp, tp = _models()
    jl, tl = jp["dec"][0]["cross_attn"], tp["dec"][0]["cross_attn"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    got = A.cross_attention(cfg, tl, _t(x), _t(enc))
    _close(got, JA.cross_attention(jcfg, jl, jnp.asarray(x),
                                   jnp.asarray(enc)), what="cross")
    k, v = A.project_kv(cfg, tl, _t(enc), None, rope=False)
    kv = {"k": k, "v": v}
    jk, jv = JA.project_kv(jcfg, jl, jnp.asarray(enc), None, rope=False)
    dec = A.cross_attention_decode(cfg, tl, _t(x[:, :1]), kv)
    _close(dec, JA.cross_attention_decode(jcfg, jl, jnp.asarray(x[:, :1]),
                                          {"k": jk, "v": jv}), what="decode")
    # the decode form is the chunked form at one query
    _close(dec, got[:, :1], what="decode vs chunked")


# ---------------------------------------------------------------------------
# encoder, decoder, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan", [False, True])
def test_encode_decode_train_and_loss_equal_the_reference(scan):
    jcfg, cfg, jp, tp = _models(scan)
    b = _batch(cfg, 2, 12, seed=5)
    enc = E.encode(cfg, tp, _t(b["frames"]))
    jenc = JE.encode(jcfg, jp, jnp.asarray(b["frames"]))
    _close(enc, jenc, what="encode")
    h = E.decode_train(cfg, tp, _t(b["tokens"]).long(), enc)
    _close(h, JE.decode_train(jcfg, jp, jnp.asarray(b["tokens"]), jenc),
           what="decode_train")
    _close(E.loss_fn(cfg, tp, _tb(b)),
           JE.loss_fn(jcfg, jp, jax.tree.map(jnp.asarray, b)), what="loss")


@pytest.mark.parametrize("scan", [False, True])
def test_loss_gradients_equal_the_reference(scan):
    jcfg, cfg, jp, tp = _models(scan)
    b = _batch(cfg, 2, 16, seed=7)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, bb: JE.loss_fn(jcfg, p, bb)))(jp, jax.tree.map(jnp.asarray, b))
    tl, tg = microbatch_grads(lambda p, bb: E.loss_fn(cfg, p, bb), tp,
                              _tb(b), 1)
    _close(tl, jl, what="loss")
    got = jax.tree.leaves(W.to_numpy(tg))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jg))
    assert len(got) == len(want)
    for a, w in zip(got, want):
        _close(a, w, what="gradient leaf")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan", [False, True])
def test_prefill_equals_the_reference(scan):
    """Logits, the cross cache and the self cache's S slots; with max_seq
    the self cache has room past them, zero."""
    jcfg, cfg, jp, tp = _models(scan)
    b = _batch(cfg, 2, 9, seed=11)
    jlg, jc = JE.prefill(jcfg, jp, jnp.asarray(b["tokens"]),
                         jnp.asarray(b["frames"]))
    lg, c = E.prefill(cfg, tp, _t(b["tokens"]).long(), _t(b["frames"]),
                      max_seq=13)
    _close(lg, jlg, what="logits")
    layers = E._layers(cfg, c, cfg.n_layers)
    jlayers = ([jax.tree.map(lambda x, i=i: x[i], jc)
                for i in range(cfg.n_layers)] if scan else jc)
    for tl_, jl_ in zip(layers, jlayers):
        for k in ("k", "v"):
            _close(tl_["cross"][k], jl_["cross"][k], what=f"cross {k}")
            assert tl_["self"][k].shape[1] == 13
            _close(tl_["self"][k][:, :9], jl_["self"][k], what=f"self {k}")
            assert not bool(tl_["self"][k][:, 9:].any())
    with pytest.raises(ValueError, match="max_seq"):
        E.prefill(cfg, tp, _t(b["tokens"]).long(), _t(b["frames"]),
                  max_seq=8)


@pytest.mark.parametrize("scan", [False, True])
def test_decode_step_at_position_0_equals_the_reference(scan):
    """At position 0 the reference's position-0 sinusoid is the right one:
    one decode step from the same cache equals the reference's."""
    jcfg, cfg, jp, tp = _models(scan)
    b = _batch(cfg, 2, 6, seed=13)
    _, jc = JE.prefill(jcfg, jp, jnp.asarray(b["tokens"]),
                       jnp.asarray(b["frames"]))
    c = jax.tree.map(lambda x: _t(np.array(x)), jc)
    if not scan:
        c = list(c)
    tok = b["tokens"][:, :1]
    jlg, _ = JE.decode_step(jcfg, jp, jnp.asarray(tok), jc,
                            jnp.zeros((2,), jnp.int32))
    lg, _ = E.decode_step(cfg, tp, _t(tok).long(), c,
                          torch.zeros(2, dtype=torch.long))
    _close(lg, jlg, what="decode at 0")


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("S", [1, 8, 17])
def test_prefill_then_16_decodes_equal_the_full_forward(S, scan):
    """prefill(S, max_seq=S+16) then 16 decode steps (each token's sinusoid
    at its own position, each written to its own slot) equal the port's
    full forward over S + 16, within 1e-4 of the largest logit."""
    _, cfg, _, tp = _models(scan)
    n = 16
    b = _batch(cfg, 2, S + n, seed=S)
    toks, frames = _t(b["tokens"]).long(), _t(b["frames"])
    full = E.forward_logits(cfg, tp, toks, frames, start=S - 1)
    lg, cache = E.prefill(cfg, tp, toks[:, :S], frames, max_seq=S + n)
    scale = float(full.abs().max())
    assert float((lg - full[:, 0]).abs().max()) <= 1e-4 * scale
    for i in range(n - 1):
        lg, cache = E.decode_step(cfg, tp, toks[:, S + i:S + i + 1], cache,
                                  torch.full((2,), S + i))
        err = float((lg - full[:, i + 1]).abs().max())
        assert err <= 1e-4 * scale, (i, err, scale)
    lg, cache = E.decode_step(cfg, tp, toks[:, S + n - 1:S + n], cache,
                              torch.full((2,), S + n - 1))
    assert bool(torch.isfinite(lg).all())


def test_the_references_serving_gaps_are_faults_10_and_11():
    """The reference's decode adds the position-0 sinusoid to every token
    (fault 10) and its prefill leaves no slot to decode into (fault 11):
    a prefill of 8 and one decode differ from the full forward over 9
    tokens by far more than f32 round-off, with either fault alone, while
    the port's own path equals it.  The gaps' sizes are recorded."""
    jcfg, cfg, jp, tp = _models()
    b = _batch(cfg, 2, 9, seed=0)
    toks, frames = b["tokens"], b["frames"]
    full = E.forward_logits(cfg, tp, _t(toks).long(), _t(frames), start=7)
    scale = float(full.abs().max())
    jlg, jc = JE.prefill(jcfg, jp, jnp.asarray(toks[:, :8]),
                         jnp.asarray(frames))
    _close(jlg, full[:, 0].numpy(), what="prefill alone")
    pos = jnp.full((2,), 8, jnp.int32)
    # both faults: the reference's own path
    both, _ = JE.decode_step(jcfg, jp, jnp.asarray(toks[:, 8:9]), jc, pos)
    # fault 10 alone: room to decode (the cache padded by one slot)
    padded = jax.tree.map(
        lambda x: jnp.pad(x, ((0, 0), (0, 1), (0, 0), (0, 0))), jc)
    padded = [{"self": p["self"], "cross": c["cross"]}
              for p, c in zip(padded, jc)]
    f10, _ = JE.decode_step(jcfg, jp, jnp.asarray(toks[:, 8:9]), padded, pos)
    gaps = {name: float(np.abs(np.asarray(x) - full[:, 1].numpy()).max())
            / scale for name, x in (("both", both), ("fault 10", f10))}
    assert gaps["both"] > 1e-2 and gaps["fault 10"] > 1e-2, gaps
    _, c = E.prefill(cfg, tp, _t(toks[:, :8]).long(), _t(frames), max_seq=9)
    lg, _ = E.decode_step(cfg, tp, _t(toks[:, 8:9]).long(), c,
                          torch.full((2,), 8))
    assert float((lg - full[:, 1]).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _final_files(root, step):
    d = root / f"step_{step:08d}"
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.suffix == ".npy"}


def test_train_launcher_crash_and_resume_is_bitwise(tmp_path):
    """--smoke --device cpu: finite losses on the frames batch; a crash at
    step 3 (checkpoints every 2) against the same run without it, the
    final checkpoints bit for bit."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "5",
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


def test_train_launcher_batches_carry_the_references_frames(tmp_path):
    """The launcher's batch of step s is the reference's
    `synthetic_token_batches(..., frames=(enc_seq, d_model))` at seed
    1234 + s."""
    from repro.data.tokens import synthetic_token_batches as jbatches
    run = TRAIN.build_model_lm(TRAIN.parse_args(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--ckpt-dir",
         str(tmp_path)]))
    cfg = run["cfg"]
    for s in (0, 3):
        got = run["data_at"](s)
        want = next(jbatches(4, 64, cfg.vocab_size, seed=1234 + s,
                             frames=(cfg.enc_seq, cfg.d_model)))
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k].numpy(), want[k])
