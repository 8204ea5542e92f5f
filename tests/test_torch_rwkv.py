"""The port's RWKV6 model (`repro_torch.models.rwkv`) held against the JAX
package's on the same parameters and inputs, at the reduced same-family
config (`smoke_config(rwkv6-3b)`: 2 layers, d 64, 4 heads of 16, f32),
with the layers both stacked (`scan_layers=True`) and listed.

Parameters are the reference's own `materialize` draw, moved to numpy,
with seeded numpy noise added to every leaf so that the zero-initialised
LoRA up-projections and biases take part; both packages get the same
arrays.  Tolerance: within 1e-5 of the largest magnitude of the
reference's result (the same f32 sums, associated differently by the two
libraries).  Prefill against a teacher-forced decode inside the port: the
reference's own 3e-3 (`tests/test_models_smoke.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, smoke_config as jsmoke
from repro.models import get_model as jget_model, rwkv as JRW
from repro.models.module import count_params as jcount, materialize as jmaterialize
from repro_torch import weights as W
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import get_model, rwkv as RW
from repro_torch.models.module import count_params, materialize
from repro_torch.tree import tree_leaves, tree_map

REL = 1e-5


def _close(got, want, rel=REL):
    got = got.detach().cpu().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _items(tree, prefix=""):
    """{path: leaf} of a nested dict/list tree (dict order ignored)."""
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _items(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: x for i, v in enumerate(tree)
                for p, x in _items(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _close_trees(got, want):
    g, w = _items(got), _items(want)
    assert sorted(g) == sorted(w)
    for key in w:
        _close(g[key], w[key])


def _models(scan: bool, seed: int = 1):
    jcfg = jsmoke(jget_config("rwkv6-3b")).replace(scan_layers=scan)
    cfg = smoke_config(get_config("rwkv6-3b")).replace(scan_layers=scan)
    tree = jax.tree.map(np.asarray, jmaterialize(jget_model(jcfg).specs(jcfg),
                                                 jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype), tree)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), \
        W.params_from_numpy(tree, "cpu", dtype=None)


@pytest.fixture(scope="module", params=[False, True], ids=["listed", "stacked"])
def models(request):
    return _models(request.param)


def _layer0(cfg, units):
    return tree_map(lambda t: t[0], units) if cfg.scan_layers else units[0]


def _x(B, T, d, seed=0):
    return np.random.default_rng(seed).standard_normal((B, T, d)).astype(np.float32)


def _tokens(B, T, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T))


def test_specs_materialize_and_count_match_reference():
    for scan in (False, True):
        jcfg, cfg, jp, tp = _models(scan)
        specs = RW.rwkv_model_specs(cfg)
        assert count_params(specs) == jcount(JRW.rwkv_model_specs(jcfg))
        drawn = materialize(specs, torch.Generator().manual_seed(0))
        again = materialize(specs, torch.Generator().manual_seed(0))
        want = {k: (tuple(t.shape), t.dtype) for k, t in _items(tp).items()}
        assert {k: (tuple(t.shape), t.dtype)
                for k, t in _items(drawn).items()} == want
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(drawn), tree_leaves(again)))
        assert count_params(drawn) == count_params(specs)


def test_full_config_matches_reference():
    full, jfull = get_config("rwkv6-3b"), jget_config("rwkv6-3b")
    for f in ("n_layers", "d_model", "n_heads", "head_dim", "d_ff",
              "vocab_size", "rwkv_chunk", "scan_layers", "norm_eps"):
        assert getattr(full, f) == getattr(jfull, f), f
    assert full.param_dtype == torch.bfloat16
    assert count_params(RW.rwkv_model_specs(full)) == \
        jcount(JRW.rwkv_model_specs(jfull))


def test_ddlerp_inputs_and_decay_match_reference(models):
    jcfg, cfg, jp, tp = models
    x = _x(2, 16, cfg.d_model)
    prev = _x(1, 2, cfg.d_model, seed=5)[0]
    p, jpl = _layer0(cfg, tp["units"])["tm"], _layer0(jcfg, jp["units"])["tm"]
    for pv in (None, prev):
        got = RW.ddlerp_inputs(cfg, p, torch.from_numpy(x),
                               None if pv is None else torch.from_numpy(pv))
        want = JRW.ddlerp_inputs(jcfg, jpl, jnp.asarray(x),
                                 None if pv is None else jnp.asarray(pv))
        assert sorted(got) == sorted(want)
        for c in want:
            _close(got[c], want[c])
    _close(RW.decay_logw(cfg, p, torch.from_numpy(x)),
           JRW.decay_logw(jcfg, jpl, jnp.asarray(x)))


def _wkv_inputs(B, H, T, D, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, H, T, D))).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32)
    S0 = rng.standard_normal((B, H, D, D)).astype(np.float32)
    return r, k, v, logw, u, S0


def test_wkv_chunk_matches_reference():
    arrays = _wkv_inputs(2, 3, 8, 16)
    o, S = RW.wkv_chunk(*map(torch.from_numpy, arrays))
    jo, jS = JRW.wkv_chunk(*map(jnp.asarray, arrays))
    _close(o, jo)
    _close(S, jS)


@pytest.mark.parametrize("with_S0", [False, True])
def test_wkv_full_matches_reference(models, with_S0):
    jcfg, cfg = models[:2]
    r, k, v, logw, u, S0 = _wkv_inputs(2, 4, 24, 16, seed=3)
    tr = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3))   # [B,T,H,D]
    args = [tr(a) for a in (r, k, v, logw)] + [u]
    S0 = S0 if with_S0 else None
    o, S = RW.wkv_full(cfg, *map(torch.from_numpy, args),
                       None if S0 is None else torch.from_numpy(S0))
    jo, jS = JRW.wkv_full(jcfg, *map(jnp.asarray, args),
                          None if S0 is None else jnp.asarray(S0))
    _close(o, jo)
    _close(S, jS)


def test_time_mix_and_channel_mix_match_reference(models):
    jcfg, cfg, jp, tp = models
    x = _x(2, 16, cfg.d_model, seed=1)
    p, jpl = _layer0(cfg, tp["units"]), _layer0(jcfg, jp["units"])
    B, H, D = 2, RW.n_heads(cfg), cfg.head_dim
    rng = np.random.default_rng(2)
    state = {"S": rng.standard_normal((B, H, D, D)).astype(np.float32),
             "x_tm": rng.standard_normal((B, cfg.d_model)).astype(np.float32),
             "x_cm": rng.standard_normal((B, cfg.d_model)).astype(np.float32)}
    for st in (None, state):
        tst = None if st is None else {k: torch.from_numpy(v) for k, v in st.items()}
        jst = None if st is None else {k: jnp.asarray(v) for k, v in st.items()}
        out, new = RW.time_mix(cfg, p["tm"], torch.from_numpy(x), state=tst)
        jout, jnew = JRW.time_mix(jcfg, jpl["tm"], jnp.asarray(x), state=jst)
        _close(out, jout)
        _close(new["S"], jnew["S"])
        _close(new["x_tm"], jnew["x_tm"])
        out, new = RW.channel_mix(cfg, p["cm"], torch.from_numpy(x), state=tst)
        jout, jnew = JRW.channel_mix(jcfg, jpl["cm"], jnp.asarray(x), state=jst)
        _close(out, jout)
        _close(new["x_cm"], jnew["x_cm"])
    _close(RW.group_norm_heads(cfg, p["tm"], torch.from_numpy(x).reshape(2, 16, H, D)),
           JRW.group_norm_heads(jcfg, jpl["tm"], jnp.asarray(x).reshape(2, 16, H, D)))


def test_backbone_matches_reference(models):
    jcfg, cfg, jp, tp = models
    x = _x(2, 16, cfg.d_model, seed=4)
    _close(RW.backbone(cfg, tp, torch.from_numpy(x)),
           JRW.backbone(jcfg, jp, jnp.asarray(x)))


def test_prefill_matches_reference(models):
    jcfg, cfg, jp, tp = models
    toks = _tokens(2, 32, cfg.vocab_size)
    logits, cache = RW.prefill(cfg, tp, torch.from_numpy(toks))
    jlogits, jcache = JRW.prefill(jcfg, jp, jnp.asarray(toks))
    assert logits.dtype == torch.float32 and logits.shape == (2, cfg.vocab_size)
    _close(logits, jlogits)
    assert isinstance(cache, dict if cfg.scan_layers else list)
    _close_trees(cache, jcache)


def test_init_cache_and_decode_step_match_reference(models):
    jcfg, cfg, jp, tp = models
    B = 2
    cache = RW.init_cache(cfg, B, 16, "cpu")
    jcache = JRW.init_cache(jcfg, B, 16)
    _close_trees(cache, jcache)
    assert [t.dtype for t in tree_leaves(cache)] == \
        [torch.float32] * len(tree_leaves(cache))
    toks = _tokens(B, 6, cfg.vocab_size, seed=7)
    for t in range(toks.shape[1]):
        logits, cache = RW.decode_step(cfg, tp, torch.from_numpy(toks[:, t:t + 1]),
                                       cache, None)
        jlogits, jcache = JRW.decode_step(jcfg, jp, jnp.asarray(toks[:, t:t + 1]),
                                          jcache, jnp.full((B,), t, jnp.int32))
        _close(logits, jlogits)
    _close_trees(cache, jcache)
    # and from a prefill cache, as the serving path continues
    _, cache = RW.prefill(cfg, tp, torch.from_numpy(toks[:, :4]))
    _, jcache = JRW.prefill(jcfg, jp, jnp.asarray(toks[:, :4]))
    logits, _ = RW.decode_step(cfg, tp, torch.from_numpy(toks[:, 4:5]), cache, None)
    jlogits, _ = JRW.decode_step(jcfg, jp, jnp.asarray(toks[:, 4:5]), jcache, None)
    _close(logits, jlogits)


def test_prefill_matches_teacher_forced_decode(models):
    """Inside the port, as the reference checks itself: stepping the decoder
    over a prompt reproduces the prefill's logits and state."""
    cfg, tp = models[1], models[3]
    B, S = 1, 16
    toks = torch.from_numpy(_tokens(B, S, cfg.vocab_size, seed=3))
    logits_p, cache_p = RW.prefill(cfg, tp, toks)
    cache = RW.init_cache(cfg, B, S + 1, "cpu")
    for t in range(S):
        logits_d, cache = RW.decode_step(cfg, tp, toks[:, t:t + 1], cache, None)
    np.testing.assert_allclose(logits_d.numpy(), logits_p.numpy(),
                               atol=3e-3, rtol=3e-3)
    for a, b in zip(tree_leaves(cache), tree_leaves(cache_p)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-3, rtol=3e-3)


def test_prefill_needs_chunk_aligned_prompts(models):
    cfg, tp = models[1], models[3]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        RW.prefill(cfg, tp, torch.zeros((1, 12), dtype=torch.long))
    # shorter than one chunk: the chunk is the prompt (L = min(chunk, T))
    logits, _ = RW.prefill(cfg, tp, torch.zeros((1, 5), dtype=torch.long))
    assert bool(torch.isfinite(logits).all())


def test_model_api_and_unported_families_raise():
    cfg = smoke_config(get_config("rwkv6-3b"))
    api = get_model(cfg)
    assert api.family == "rwkv6" and api.prefill is RW.prefill
    # RWKV6 training and every other family are ported: the decoder
    # family (dense and MoE), the rglru model and the encoder-decoder
    assert api.loss_fn is RW.loss_fn
    assert get_model(get_config("yi-6b").replace(moe=True)).family == "decoder"
    assert get_model(cfg.replace(family="rglru")).family == "rglru"
    assert get_model(cfg.replace(family="encdec")).family == "encdec"
    with pytest.raises(ValueError, match="unknown family"):
        get_model(cfg.replace(family="nope"))
    assert get_config("whisper-large-v3").family == "encdec"
    for arch in ("olmoe-1b-7b", "recurrentgemma-9b"):
        assert get_config(arch).name == arch
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    assert get_config("egru-spiral").n_hidden == 16
