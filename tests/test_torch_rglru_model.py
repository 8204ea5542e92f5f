"""The port's Griffin RG-LRU LM (`repro_torch.models.rglru`,
`configs/recurrentgemma_9b.py`) held against the JAX package on the same
inputs: numpy arrays made from a seed, and the reference's own parameters
(`materialize` at a key) moved to the port through
`weights.params_from_numpy`.  f32 smoke configs (4 layers: one unit of
(rec, rec2, attn) and one `rem` layer; local window 16), with the units
stacked (`scan_layers`) and listed.

Tolerances: 1e-5 of the largest magnitude for the scan, blocks, logits and
the loss; 1e-5 of each leaf's largest entry for gradients.  The
reference's prefill leaves no room to decode (ROADMAP Queue 3, fault 9),
so `prefill(max_seq=N)` followed by decode is held against the port's own
full forward, at prompts shorter and longer than the window.  The Engine
case: a reused slot of a stacked (`scan_layers`) cache starts from a zero
state (fault 6).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, smoke_config as jsmoke
from repro.models import rglru as JR
from repro.models.module import count_params as jcount
from repro.models.module import materialize as jmaterialize
from repro_torch import weights as W
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import get_model, rglru as R
from repro_torch.models.module import count_params, materialize, uniform_init
from repro_torch.optim.grad import microbatch_grads
from repro_torch.runtime.serving import Engine, ServeConfig

ARCH = "recurrentgemma-9b"
REL = 1e-5


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(scan=False, **kw):
    """(reference cfg, port cfg, reference params, port params), f32 smoke."""
    jcfg = jsmoke(jget_config(ARCH)).replace(scan_layers=scan, **kw)
    cfg = smoke_config(get_config(ARCH)).replace(scan_layers=scan, **kw)
    jp = jmaterialize(JR.rglru_model_specs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, W.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _lru(jp, tp, scan):
    """The first recurrent block's parameters of both trees."""
    if scan:
        return (jax.tree.map(lambda a: a[0], jp["units"]["rec"]["lru"]),
                {k: v[0] for k, v in tp["units"]["rec"]["lru"].items()})
    return jp["units"][0]["rec"]["lru"], tp["units"][0]["rec"]["lru"]


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_config_and_full_size_specs_equal_the_reference():
    want, got = jget_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert str(b) == f"torch.{jnp.dtype(a).name}", f.name
        else:
            assert a == b, f.name
    assert get_model(got).family == "rglru"
    # specs only: 12 stacked units, 2 rem layers, lambda f32 in a bf16 model
    specs = R.rglru_model_specs(got)
    assert count_params(specs) == jcount(JR.rglru_model_specs(want)) \
        == 9_396_195_328
    assert count_params(R.rglru_model_specs(got.replace(n_layers=5))) \
        == 2_174_889_984
    assert specs["units"]["rec"]["lru"]["lambda"].shape == (12, 4096)
    assert specs["units"]["rec"]["lru"]["lambda"].dtype == torch.float32
    assert specs["units"]["rec"]["lru"]["wx"].dtype == torch.bfloat16
    assert len(specs["rem"]) == 2 and R.n_units(got) == (12, 2)


def test_bf16_reference_tree_crosses_with_its_dtypes():
    jcfg = jsmoke(jget_config(ARCH)).replace(param_dtype=jnp.bfloat16,
                                              scan_layers=True)
    jp = jmaterialize(JR.rglru_model_specs(jcfg), jax.random.key(0))
    tp = W.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", dtype=None)
    assert tp["units"]["rec"]["lru"]["lambda"].dtype == torch.float32
    assert tp["units"]["rec"]["lru"]["wx"].dtype == torch.bfloat16
    assert tp["units"]["attn"]["attn"]["wq"].shape[0] == 1    # [U, ...]
    assert isinstance(tp["rem"], list) and len(tp["rem"]) == 1
    for a, w in zip(jax.tree.leaves(W.to_numpy(tp)),
                    jax.tree.leaves(jax.tree.map(
                        lambda x: np.asarray(x, np.float32), jp))):
        assert np.array_equal(a, w)


def test_uniform_init_draws_in_its_range_from_the_generator():
    init = uniform_init(2.2, 5.5)
    a = init(torch.Generator().manual_seed(3), (4096,), torch.float32)
    b = init(torch.Generator().manual_seed(3), (4096,), torch.float32)
    assert torch.equal(a, b) and 2.2 <= float(a.min()) < float(a.max()) < 5.5
    assert init(torch.Generator(), (3,), torch.bfloat16).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the RG-LRU core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("T", [1, 2, 7, 16, 33])
def test_scan_equals_the_reference_and_a_sequential_loop(T, with_h0):
    rng = np.random.default_rng(T)
    log_a = (-3.0 * rng.random((2, T, 8))).astype(np.float32)
    x_in = rng.standard_normal((2, T, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32) if with_h0 else None
    got = R.rglru_scan(_t(log_a), _t(x_in), None if h0 is None else _t(h0))
    want = JR.rglru_scan(jnp.asarray(log_a), jnp.asarray(x_in),
                         None if h0 is None else jnp.asarray(h0))
    _close(got, want, what="scan vs reference")
    h = torch.zeros(2, 8) if h0 is None else _t(h0)
    loop = []
    for t in range(T):
        h = torch.exp(_t(log_a[:, t])) * h + _t(x_in[:, t])
        loop.append(h)
    _close(got, torch.stack(loop, 1), what="scan vs loop")


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_causal_and_gates_equal_the_reference(with_state):
    jcfg, cfg, jp, tp = _models()
    jl, tl = _lru(jp, tp, False)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, cfg.lru_width)).astype(np.float32)
    st = (rng.standard_normal((2, cfg.conv_width - 1, cfg.lru_width))
          .astype(np.float32) if with_state else None)
    out, hist = R.conv1d_causal(cfg, tl, _t(x), None if st is None else _t(st))
    jout, jhist = JR.conv1d_causal(jcfg, jl, jnp.asarray(x),
                                   None if st is None else jnp.asarray(st))
    _close(out, jout, what="conv")
    assert np.array_equal(hist.numpy(), np.asarray(jhist))
    la, xi = R._gates(cfg, tl, _t(x))
    jla, jxi = JR._gates(jcfg, jl, jnp.asarray(x))
    _close(la, jla, what="log_a")
    _close(xi, jxi, what="x_in")


def test_blocks_and_their_decode_form_equal_the_reference():
    jcfg, cfg, jp, tp = _models()
    jl, tl = _lru(jp, tp, False)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    _close(R.rglru_block(cfg, tl, _t(x)),
           JR.rglru_block(jcfg, jl, jnp.asarray(x)), what="block")
    st = {"h": rng.standard_normal((2, cfg.lru_width)).astype(np.float32),
          "conv": rng.standard_normal((2, cfg.conv_width - 1, cfg.lru_width))
          .astype(np.float32)}
    o, ns = R.rglru_block_decode(cfg, tl, _t(x[:, :1]),
                                 {k: _t(v) for k, v in st.items()})
    jo, jns = JR.rglru_block_decode(jcfg, jl, jnp.asarray(x[:, :1]),
                                    jax.tree.map(jnp.asarray, st))
    _close(o, jo, what="decode block")
    for k in ("h", "conv"):
        _close(ns[k], jns[k], what=f"decode state {k}")
    # the decode form stepped over the sequence is the block
    state = {k: torch.zeros_like(_t(v)) for k, v in st.items()}
    outs = []
    for t in range(11):
        o, state = R.rglru_block_decode(cfg, tl, _t(x[:, t:t + 1]), state)
        outs.append(o)
    _close(torch.cat(outs, 1), R.rglru_block(cfg, tl, _t(x)),
           what="stepped decode vs block")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("scan", [False, True])
def test_loss_and_gradients_equal_the_reference(scan, remat):
    jcfg, cfg, jp, tp = _models(scan, remat=remat)
    toks = _tokens(cfg, 2, 25, seed=7)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.jit(jax.value_and_grad(lambda p, bb: JR.loss_fn(jcfg, p, bb)))(
        jp, jax.tree.map(jnp.asarray, b))
    tl, tg = microbatch_grads(lambda p, bb: R.loss_fn(cfg, p, bb), tp,
                              {k: _t(v).long() for k, v in b.items()}, 1)
    _close(tl, jl, what="loss")
    got = jax.tree.leaves(W.to_numpy(tg))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jg))
    assert len(got) == len(want)
    for a, w in zip(got, want):
        _close(a, w, what="gradient leaf")


@pytest.mark.parametrize("scan", [False, True])
def test_teacher_forced_decode_equals_the_reference(scan):
    """decode_step from an empty cache, token by token past the window."""
    jcfg, cfg, jp, tp = _models(scan)
    S = 20
    toks = _tokens(cfg, 2, S, seed=3)
    c, jc = R.init_cache(cfg, 2, S), JR.init_cache(jcfg, 2, S)
    jdecode = jax.jit(functools.partial(JR.decode_step, jcfg))
    for t in range(S):
        pos = np.full((2,), t, np.int32)
        lg, c = R.decode_step(cfg, tp, _t(toks[:, t:t + 1]).long(), c, _t(pos))
        jlg, jc = jdecode(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                          jnp.asarray(pos))
        _close(lg, jlg, what=f"decode step {t}")
    _close(lg, R.forward_logits(cfg, tp, _t(toks).long(), start=S - 1)[:, 0],
           what="decode vs the full forward")


@pytest.mark.parametrize("scan", [False, True])
def test_prefill_equals_the_reference_at_its_own_length(scan):
    """At max_seq = S below the window the reference's cache layout is the
    port's (fault 9 shows only once decode goes on)."""
    jcfg, cfg, jp, tp = _models(scan)
    toks = _tokens(cfg, 2, 12, seed=5)
    lg, cache = R.prefill(cfg, tp, _t(toks).long())
    jlg, jcache = jax.jit(functools.partial(JR.prefill, jcfg))(
        jp, jnp.asarray(toks))
    _close(lg, jlg, what="prefill logits")
    for a, w in zip(jax.tree.leaves(W.to_numpy(cache)), jax.tree.leaves(jcache)):
        _close(a, w, what="prefill state")


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("S", [8, 16, 20, 37])
def test_prefill_leaves_room_to_decode(S, scan):
    """prefill(S, max_seq=S+n) then n decode steps equals the full forward
    over S+n, below and above the window of 16 (the ring wraps)."""
    _, cfg, _, tp = _models(scan)
    n = 10
    toks = torch.randint(0, cfg.vocab_size, (2, S + n),
                         generator=torch.Generator().manual_seed(S))
    full = R.forward_logits(cfg, tp, toks, start=S - 1)
    lg, cache = R.prefill(cfg, tp, toks[:, :S], max_seq=S + n)
    _close(lg, full[:, 0], what="prefill")
    for i in range(n):
        lg, cache = R.decode_step(cfg, tp, toks[:, S + i:S + i + 1], cache,
                                  torch.full((2,), S + i))
        _close(lg, full[:, i + 1], what=f"decode {i}")
    with pytest.raises(ValueError, match="max_seq"):
        R.prefill(cfg, tp, toks, max_seq=S)


def test_stacked_engine_reuses_slot_3_from_a_zero_state():
    """4 slots, scan_layers: the stacked units' state is [U, B, ...] and the
    rem layers' [B, ...].  6 requests: slot 3 is admitted twice, and every
    request's tokens are those of the same prompt served alone."""
    cfg = smoke_config(get_config(ARCH)).replace(scan_layers=True)
    scfg = ServeConfig(batch_slots=4, max_seq=32)
    eng = Engine(cfg, scfg, device="cpu")
    assert eng.batch_axes[("rem", 0, "conv")] == 0
    assert eng.batch_axes[("units", "rec", "conv")] == 1
    slots, add = [], eng.add_request

    def add_request(prompt):
        slot = add(prompt)
        if slot is not None:
            slots.append(slot)
        return slot
    eng.add_request = add_request
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (9, 8, 7, 3, 5, 6)]
    outs = eng.generate(prompts, max_new=6)
    assert slots.count(3) == 2 and len(slots) == 6
    for p, out in zip(prompts, outs):
        solo = Engine(cfg, scfg, params=eng.params, device="cpu")
        assert solo.generate([p], max_new=6) == [out]


def test_engine_draws_the_model_from_its_seed():
    cfg = smoke_config(get_config(ARCH))
    a = Engine(cfg, ServeConfig(batch_slots=2, max_seq=16), device="cpu")
    want = materialize(R.rglru_model_specs(cfg),
                       torch.Generator().manual_seed(0))
    assert torch.equal(a.params["rem"][0]["lru"]["lambda"],
                       want["rem"][0]["lru"]["lambda"])
