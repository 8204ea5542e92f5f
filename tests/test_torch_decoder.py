"""The port's dense decoder family (`repro_torch.models.{layers,attention,
transformer}`, `kernels.ref.flash_attention_ref`, `configs`) held against
the JAX package on the same inputs: numpy arrays made from a seed, and the
reference's own parameters (`materialize` at a key) moved to the port
through `weights.params_from_numpy`.  f32 smoke configs, with the units
stacked (`scan_layers`) and listed.

Tolerances: 1e-5 of the largest magnitude for attention, logits and the
loss; 1e-5 of each leaf's largest entry for gradients.  Inside the port,
remat is bitwise, and prefill followed by decode equals the full forward
(the reference's prefill leaves no room to decode: ROADMAP Queue 3, fault
7, so that case is held against the port's own full forward).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, smoke_config as jsmoke
from repro.kernels import ref as JREF
from repro.models import attention as JA, layers as JL, transformer as JT
from repro.models.module import materialize as jmaterialize
from repro_torch import weights as W
from repro_torch.configs import NOT_PORTED, get_config, smoke_config
from repro_torch.kernels import ref as REF
from repro_torch.models import attention as A, get_model, layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.grad import microbatch_grads

DECODERS = ["gemma2-2b", "qwen3-8b", "yi-6b", "minitron-8b", "internvl2-2b"]
REL = 1e-5


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _models(arch, scan=False, **kw):
    """(reference cfg, port cfg, reference params, port params), f32 smoke."""
    jcfg = jsmoke(jget_config(arch)).replace(scan_layers=scan, **kw)
    cfg = smoke_config(get_config(arch)).replace(scan_layers=scan, **kw)
    jp = jmaterialize(JT.decoder_specs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, W.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    if cfg.n_patches:
        b["patch_embeds"] = (rng.standard_normal((B, cfg.n_patches, 4096))
                             * 0.02).astype(np.float32)
        b["labels"][:, :cfg.n_patches] = -1
    return b


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODERS)
def test_configs_equal_the_reference_field_for_field(arch):
    want, got = jget_config(arch), get_config(arch)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert str(b) == f"torch.{jnp.dtype(a).name}", f.name
        else:
            assert a == b, f.name
    assert get_model(got).family == "decoder"


def test_unported_archs_and_families_raise_naming_item_14():
    """Nothing is left unported: every arch resolves (whisper-large-v3 too),
    and so do a MoE decoder (models/moe.py), the rglru family
    (models/rglru.py) and the encoder-decoder (models/encdec.py); an
    unknown family still raises."""
    from repro_torch.configs import ARCHS
    assert NOT_PORTED == frozenset()
    for arch in sorted(ARCHS):
        assert get_config(arch).name == arch
    assert get_config("whisper-large-v3").family == "encdec"
    cfg = smoke_config(get_config("yi-6b"))
    moe = cfg.replace(moe=True, n_experts=4, top_k=2)
    assert get_model(moe).family == "decoder"
    assert "router" in T.decoder_specs(moe)["units"][0]["global"]["mlp"]
    assert get_model(cfg.replace(family="rglru")).family == "rglru"
    assert get_model(cfg.replace(family="encdec")).family == "encdec"
    with pytest.raises(ValueError, match="unknown family"):
        get_model(cfg.replace(family="nope"))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_rope_sinusoid_and_mlp_equal_the_reference(act):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    _close(L.apply_rope(_t(x), _t(pos), 10_000.0),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), what="rope")
    _close(L.sinusoidal_pos_emb(9, 16), JL.sinusoidal_pos_emb(9, 16), what="sin")
    jcfg = jsmoke(jget_config("yi-6b")).replace(mlp_act=act)
    cfg = smoke_config(get_config("yi-6b")).replace(mlp_act=act)
    jp = jmaterialize(JL.mlp_specs(jcfg), jax.random.key(3))
    h = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    _close(L.mlp(cfg, W.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                 _t(h)), JL.mlp(jcfg, jp, jnp.asarray(h)), what=act)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,qc,kc,H,KV,causal,window,cap", [
    (24, 16, 16, 4, 2, True, 0, 0.0),       # chunks that do not divide S
    (24, 16, 16, 4, 2, True, 10, 0.0),      # window < S across chunk edges
    (30, 8, 12, 4, 1, True, 7, 50.0),       # softcap, MQA, window
    (20, 20, 20, 4, 4, False, 0, 0.0),      # one chunk, no mask
    (36, 12, 8, 6, 2, True, 0, 30.0),       # GQA 3, softcap
    (33, 16, 16, 4, 2, False, 9, 0.0),      # a window without causality
])
def test_chunked_flash_equals_reference_and_plain(S, qc, kc, H, KV, causal,
                                                  window, cap):
    rng = np.random.default_rng(S + qc)
    D = 16
    q, k, v = (rng.standard_normal((2, S, h, D)).astype(np.float32)
               for h in (H, KV, KV))
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=D, attn_q_chunk=qc,
              attn_kv_chunk=kc, attn_softcap=cap)
    jcfg = jsmoke(jget_config("yi-6b")).replace(**kw)
    cfg = smoke_config(get_config("yi-6b")).replace(**kw)
    got = A.flash_attention(cfg, _t(q), _t(k), _t(v), causal=causal,
                            window=window)
    want = JA.flash_attention(jcfg, jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal, window=window)
    _close(got, want, what="chunked vs the reference's chunked")
    plain = REF.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                    window=window, cap=cap)
    _close(got, plain, what="chunked vs flash_attention_ref")
    assert bool(torch.isfinite(got).all())
    if cap == 0.0:     # the reference's oracle has no softcap
        _close(plain, JREF.flash_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window), what="flash_attention_ref vs the reference's")


@pytest.mark.parametrize("window,pos", [(0, [3, 11]), (6, [4, 9]),
                                        (6, [13, 22])])   # past the wrap
def test_decode_attention_and_the_ring_buffer_equal_the_reference(window, pos):
    jcfg, cfg, jp, tp = _models("gemma2-2b")
    jpa, tpa = jp["units"][0]["local"]["attn"], tp["units"][0]["local"]["attn"]
    rng = np.random.default_rng(window + pos[0])
    smax = window or 12
    cache = {n: rng.standard_normal((2, smax, cfg.n_kv_heads, cfg.head_dim))
             .astype(np.float32) for n in ("k", "v")}
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    p = np.array(pos, np.int32)
    before = {n: c.copy() for n, c in cache.items()}
    got, gc = A.self_attention_decode(cfg, tpa, _t(x),
                                      {n: _t(c) for n, c in cache.items()},
                                      _t(p), window=window)
    want, wc = JA.self_attention_decode(jcfg, jpa, jnp.asarray(x),
                                        jax.tree.map(jnp.asarray, cache),
                                        jnp.asarray(p), window=window)
    _close(got, want, what="decode attention")
    for n in ("k", "v"):
        _close(gc[n], wc[n], what=f"cache {n}")
        assert np.array_equal(cache[n], before[n])     # not written in place


# ---------------------------------------------------------------------------
# the model: prefill, decode, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_teacher_forced_decode_equal_the_reference(arch, scan):
    jcfg, cfg, jp, tp = _models(arch, scan)
    b = _batch(cfg, 2, 18, seed=5)
    pe = b.get("patch_embeds")
    got, cache = T.prefill(cfg, tp, _t(b["tokens"]),
                           None if pe is None else _t(pe))
    want, jcache = jax.jit(functools.partial(JT.prefill, jcfg))(
        jp, jnp.asarray(b["tokens"]), None if pe is None else jnp.asarray(pe))
    _close(got, want, what="prefill logits")
    # the global layers' caches are the reference's at max_seq = S
    gl = (cache["global"] if scan else [c["global"] for c in cache])
    jgl = (jcache["global"] if scan else [c["global"] for c in jcache])
    for a, w in zip(jax.tree.leaves(W.to_numpy(gl)), jax.tree.leaves(jgl)):
        _close(a, w, what="global KV cache")
    # teacher-forced decode from an empty cache with room for every token
    toks = b["tokens"]
    S = toks.shape[1]
    c, jc = T.init_cache(cfg, 2, S + 1), JT.init_cache(jcfg, 2, S + 1)
    jdecode = jax.jit(functools.partial(JT.decode_step, jcfg))
    for t in range(S):
        pos = np.full((2,), t, np.int32)
        lg, c = T.decode_step(cfg, tp, _t(toks[:, t:t + 1]), c, _t(pos))
        jlg, jc = jdecode(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                          jnp.asarray(pos))
        _close(lg, jlg, what=f"decode step {t}")
    if pe is None:
        _close(lg, want, what="decode vs prefill")


@pytest.mark.parametrize("arch,S", [("gemma2-2b", 12), ("gemma2-2b", 16),
                                    ("gemma2-2b", 24), ("yi-6b", 16),
                                    ("qwen3-8b", 21)])
def test_prefill_leaves_room_to_decode(arch, S):
    """prefill(S, max_seq=S+n) then n decode steps equals the full forward
    over S+n, past gemma2's smoke window of 16 (the ring wraps)."""
    _, cfg, _, tp = _models(arch, scan=arch == "yi-6b")
    n = 10
    toks = torch.randint(0, cfg.vocab_size, (2, S + n),
                         generator=torch.Generator().manual_seed(S))
    full = T.forward_logits(cfg, tp, toks, start=S - 1)
    lg, cache = T.prefill(cfg, tp, toks[:, :S], max_seq=S + n)
    _close(lg, full[:, 0], what="prefill")
    for i in range(n):
        lg, cache = T.decode_step(cfg, tp, toks[:, S + i:S + i + 1], cache,
                                  torch.full((2,), S + i))
        _close(lg, full[:, i + 1], what=f"decode {i}")
    with pytest.raises(ValueError, match="max_seq"):
        T.prefill(cfg, tp, toks, max_seq=S)


def _grads_close(tgrads, jgrads):
    got = jax.tree.leaves(W.to_numpy(tgrads))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jgrads))
    assert len(got) == len(want)
    for a, w in zip(got, want):
        _close(a, w, what="gradient leaf")


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("arch", DECODERS)
def test_loss_and_gradients_equal_the_reference(arch, scan):
    jcfg, cfg, jp, tp = _models(arch, scan)
    b = _batch(cfg, 2, 24, seed=7)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, bb: JT.loss_fn(jcfg, p, bb)))(
        jp, jax.tree.map(jnp.asarray, b))
    tl, tg = microbatch_grads(lambda p, bb: T.loss_fn(cfg, p, bb), tp,
                              {k: _t(v) for k, v in b.items()}, 1)
    _close(tl, jl, what="loss")
    _grads_close(tg, jg)


def test_chunked_ce_over_several_chunks_equals_the_reference():
    jcfg, cfg, jp, tp = _models("yi-6b")
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    lbl = rng.integers(-1, cfg.vocab_size, (2, 40)).astype(np.int32)
    for chunk in (16, 40, 64):    # 2 chunks (the tail dropped), 1, S < chunk
        _close(T.chunked_ce_loss(cfg, tp, _t(h), _t(lbl), chunk=chunk),
               JT.chunked_ce_loss(jcfg, jp, jnp.asarray(h), jnp.asarray(lbl),
                                  chunk=chunk), what=f"chunk {chunk}")


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-8b"])
def test_remat_is_bitwise_a_memory_policy(arch):
    _, cfg, _, tp = _models(arch, scan=True)
    b = {k: _t(v) for k, v in _batch(cfg, 2, 20, seed=9).items()}
    runs = [microbatch_grads(lambda p, bb, c=cfg.replace(remat=r):
                             T.loss_fn(c, p, bb), tp, b, 1)
            for r in ("none", "full", "dots")]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, w in zip(jax.tree.leaves(W.to_numpy(grads)),
                        jax.tree.leaves(W.to_numpy(runs[0][1]))):
            assert np.array_equal(a, w)
