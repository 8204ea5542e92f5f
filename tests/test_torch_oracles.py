"""The port's oracles held against the JAX package on the same numpy
inputs: the straight-through Heaviside, the input Jacobian B-hat, the
stacked BPTT and jacrev RTRL oracles, the streaming BPTT learner and the
cost model.

Tolerances: losses agree to 1e-5 relative and gradients to 1e-5 of the
gradient tree's largest magnitude (float32 sums associated differently by
the two libraries);
B-hat agrees with autodiff of the pre-activation to 1e-6; the cost model
is numpy in both packages and agrees exactly.  Sizes are small (n <= 16,
B <= 4, T <= 7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bptt as JB, cells as JC, costs as JCO, rtrl as JR
from repro.core import learner as JL, sparse_rtrl as JSP
from repro.core import stacked_rtrl as JST
from repro.cells import egru as JE
from repro_torch.cells import egru as E
from repro_torch.core import bptt as B, cells as C, costs as CO, rtrl as R
from repro_torch.core import stacked_rtrl as ST
from repro_torch.core.learner import LearnerSpec, make_learner
from repro_torch.optim import optimizers as O
from repro_torch.runtime import online as ON
from repro_torch.tree import tree_flatten_with_path
from repro_torch.weights import masks_from_numpy, params_from_numpy, to_numpy

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The tensors here are small: one intra-op thread a test process, so
    that parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree_np(t):
    return jax.tree.map(np.asarray, t)


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _assert_trees_close(got, want, rel=REL):
    """Every leaf within rel of the tree's largest magnitude: a leaf that
    is a small difference of large terms (the readout bias of two classes)
    carries the round-off of those terms, not of its own size."""
    got = jax.tree.leaves(to_numpy(got))
    want = jax.tree.leaves(_tree_np(want))
    assert len(got) == len(want)
    scale = max(max(float(np.abs(w).max()) for w in want), 1e-3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale)


def _stacked_setup(kind, L, *, sparsity=0.6, T=6, B=4, n_in=3, seed=0):
    """JAX-drawn stacked params and masks (layers of 8, 6 and 10 units) as
    numpy, and a sequence with per-example input scales."""
    sizes = (8, 6, 10)[:L]
    jcfg = JC.StackedEGRUConfig(layer_sizes=sizes, n_in=n_in, n_out=2,
                                kind=kind)
    cfg = C.StackedEGRUConfig(layer_sizes=sizes, n_in=n_in, n_out=2,
                              kind=kind)
    params = JC.init_stacked_params(jcfg, jax.random.key(seed))
    masks = JST.make_stacked_masks(jcfg, jax.random.key(seed + 7), sparsity)
    params = JST.apply_stacked_masks(params, masks)
    rng = np.random.default_rng(seed + 1)
    xs = (rng.normal(size=(T, B, n_in))
          * np.linspace(0.5, 2.5, B)[None, :, None]).astype(np.float32)
    ys = (np.arange(B) % 2).astype(np.int32)
    return jcfg, cfg, _tree_np(params), _tree_np(masks), xs, ys


# ---------------------------------------------------------------------------
# the straight-through Heaviside
# ---------------------------------------------------------------------------

class _OldHeavisideST(torch.autograd.Function):
    """The form the port had before `setup_context`: forward(ctx, ...)."""

    @staticmethod
    def forward(ctx, v, gamma, eps):
        ctx.save_for_backward(v)
        ctx.gamma, ctx.eps = gamma, eps
        return C.heaviside(v)

    @staticmethod
    def backward(ctx, grad):
        (v,) = ctx.saved_tensors
        hp = ctx.gamma * torch.clamp(1.0 - v.abs() / (2.0 * ctx.eps), min=0.0)
        return hp * grad, None, None


@pytest.mark.parametrize("kind", ["gru", "rnn"])
def test_heaviside_st_bptt_gradients_bitwise_as_before(kind, monkeypatch):
    """BPTT through the setup_context form equals BPTT through the old
    forward(ctx, ...) form bit for bit, single-layer and stacked."""
    jcfg, cfg, params, _, xs, ys = _stacked_setup(kind, 2)
    sp = params_from_numpy(params, "cpu")
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    single = dict(sp["layers"][0], out={
        "W": torch.ones(8, 2) * 0.1, "b": torch.zeros(2)})
    new = (B.bptt_loss_and_grads(cfg.layer_cfg(0), single, x, y),
           B.stacked_bptt_loss_and_grads(cfg, sp, x, y))
    monkeypatch.setattr(C, "_HeavisideST", _OldHeavisideST)
    old = (B.bptt_loss_and_grads(cfg.layer_cfg(0), single, x, y),
           B.stacked_bptt_loss_and_grads(cfg, sp, x, y))
    for (ln, gn, _), (lo, go, _) in zip(new, old):
        assert torch.equal(ln, lo)
        for (pa, a), (pb, b) in zip(tree_flatten_with_path(gn),
                                    tree_flatten_with_path(go)):
            assert pa == pb and torch.equal(a, b), pa


def test_heaviside_st_goes_through_jacrev_and_vmap():
    v = torch.tensor([[-1.0, -0.2, 0.0, 0.1, 0.7]])
    cfg = C.EGRUConfig(gamma=0.9, eps=0.3)
    st = lambda u: C._HeavisideST.apply(u, cfg.gamma, cfg.eps)
    J = torch.func.vmap(torch.func.jacrev(st))(v)
    torch.testing.assert_close(torch.diagonal(J, dim1=1, dim2=2),
                               C.pseudo_derivative(v, cfg), rtol=0, atol=0)
    torch.testing.assert_close(st(v), C.heaviside(v), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the input Jacobian B-hat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gru", "rnn"])
def test_cell_partials_full_matches_reference_and_autodiff(kind):
    jcfg, cfg, params, _, _, _ = _stacked_setup(kind, 2)
    lcfg, jlcfg = cfg.layer_cfg(1), jcfg.layer_cfg(1)
    rng = np.random.default_rng(3)
    a = (rng.random((4, 6)) > 0.5).astype(np.float32)
    x = (rng.random((4, 8)) > 0.4).astype(np.float32)
    w = params_from_numpy(params, "cpu")["layers"][1]
    got = E.cell_partials_full(lcfg, w, torch.from_numpy(a),
                               torch.from_numpy(x))
    want = JE.cell_partials_full(jlcfg, _jtree(params["layers"][1]),
                                 jnp.asarray(a), jnp.asarray(x))
    names = ("a_new", "hp", "Jhat", "Bhat")
    for name, g, wv in zip(names, got[:4], want[:4]):
        np.testing.assert_allclose(to_numpy(g), np.asarray(wv), rtol=0,
                                   atol=1e-6, err_msg=name)
    _assert_trees_close(got[4], want[4])
    assert tuple(got[3].shape) == (4, 6, 8)
    # B-hat is dv/dx: autodiff of the pre-activation, per example
    auto = torch.func.vmap(torch.func.jacrev(
        lambda ai, xi: C.pre_activation(lcfg, w, ai[None], xi[None])[0],
        argnums=1))(torch.from_numpy(a), torch.from_numpy(x))
    torch.testing.assert_close(got[3], auto, rtol=0, atol=1e-6)
    # without the input Jacobian: the same partials as cell_partials
    plain = E.cell_partials(lcfg, w, torch.from_numpy(a), torch.from_numpy(x))
    for g, p in zip(got[:3], plain[:3]):
        assert torch.equal(g, p)
    assert E.EGRUCell(lcfg).partials_full(
        w, torch.from_numpy(a), torch.from_numpy(x))[3].shape == got[3].shape


# ---------------------------------------------------------------------------
# the stacked BPTT and jacrev oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,L", [("gru", 1), ("rnn", 2), ("gru", 3)])
def test_stacked_oracles_match_reference(kind, L):
    jcfg, cfg, params, _, xs, ys = _stacked_setup(kind, L, T=5)
    jp, tp = _jtree(params), params_from_numpy(params, "cpu")
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    jl, jg, js = JB.stacked_bptt_loss_and_grads(jcfg, jp, jnp.asarray(xs),
                                                jnp.asarray(ys))
    tl, tg, ts = B.stacked_bptt_loss_and_grads(cfg, tp, x, y)
    assert float(tl) == pytest.approx(float(jl), rel=REL)
    _assert_trees_close(tg, jg)
    for k in ("alpha", "alpha_layers"):
        np.testing.assert_allclose(to_numpy(ts[k]), np.asarray(js[k]),
                                   rtol=1e-6)
    rl, rg, _ = JR.stacked_rtrl_loss_and_grads(jcfg, jp, jnp.asarray(xs),
                                               jnp.asarray(ys))
    ol, og, _ = R.stacked_rtrl_loss_and_grads(cfg, tp, x, y)
    assert float(ol) == pytest.approx(float(rl), rel=REL)
    _assert_trees_close(og, rg)
    # inside the port: the jacrev oracle equals BPTT
    assert float(ol) == pytest.approx(float(tl), rel=REL)
    _assert_trees_close(og, to_numpy(tg))


@pytest.mark.parametrize("kind", ["gru", "rnn"])
def test_rtrl_oracle_and_online_train_match_reference(kind):
    jcfg, cfg, params, _, xs, ys = _stacked_setup(kind, 1, T=4)
    single = dict(params["layers"][0], out=params["out"])
    jl1, l1 = jcfg.layer_cfg(0), cfg.layer_cfg(0)
    jl, jg, js = JR.rtrl_loss_and_grads(jl1, _jtree(single), jnp.asarray(xs),
                                        jnp.asarray(ys))
    tl, tg, ts = R.rtrl_loss_and_grads(l1, params_from_numpy(single, "cpu"),
                                       torch.from_numpy(xs),
                                       torch.from_numpy(ys))
    assert float(tl) == pytest.approx(float(jl), rel=REL)
    _assert_trees_close(tg, jg)
    for k in ("alpha", "m_row_density"):
        np.testing.assert_allclose(to_numpy(ts[k]), np.asarray(js[k]),
                                   rtol=1e-6)
    from repro.optim import optimizers as JO
    jopt = JO.adamw(lr=1e-2)
    jparams, _, jstep, jloss = JR.rtrl_online_train(
        jl1, _jtree(single), jnp.asarray(xs), jnp.asarray(ys), jopt,
        jopt.init(_jtree(single)), jnp.int32(0))
    opt = O.adamw(lr=1e-2)
    tsingle = params_from_numpy(single, "cpu")
    tparams, _, tstep, tloss = R.rtrl_online_train(
        l1, tsingle, torch.from_numpy(xs), torch.from_numpy(ys), opt,
        opt.init(tsingle), 0)
    assert tstep == int(jstep) == 4
    assert float(tloss) == pytest.approx(float(jloss), rel=REL)
    _assert_trees_close(tparams, jparams)


# ---------------------------------------------------------------------------
# the streaming BPTT learner
# ---------------------------------------------------------------------------

def test_bptt_learner_matches_reference_with_a_reset_window():
    """Two windows (4 and 3 steps, horizon 4) with a reset_grads and an
    update between them; a third window of 6 steps overflows the horizon
    and reports it."""
    jcfg, cfg, params, _, xs, ys = _stacked_setup("gru", 1, T=7)
    single = dict(params["layers"][0], out=params["out"])
    jl1, l1 = jcfg.layer_cfg(0), cfg.layer_cfg(0)
    yss = np.broadcast_to(ys, (7,) + ys.shape).copy()
    jlr = JL.make_learner(JL.LearnerSpec(engine="bptt", cfg=jl1, horizon=4))
    tlr = make_learner(LearnerSpec(engine="bptt", cfg=l1, horizon=4))
    jc = jlr.init(_jtree(single), None, (jnp.asarray(xs[0]),
                                        jnp.asarray(ys)), t_total=4.0)
    tc = tlr.init(params_from_numpy(single, "cpu"), None,
                  (torch.from_numpy(xs[0]), torch.from_numpy(ys)),
                  t_total=4.0)
    from repro.runtime import online as JON
    for window in (slice(0, 4), slice(4, 7)):
        jc, jloss, jg, jst = JON.stream_grads(
            jlr, jc, jnp.asarray(xs[window]), jnp.asarray(yss[window]))
        tc, tloss, tg, tst = ON.stream_grads(
            tlr, tc, torch.from_numpy(xs[window]),
            torch.from_numpy(yss[window]))
        assert float(tloss) == pytest.approx(float(jloss), rel=REL)
        _assert_trees_close(tg, jg)
        np.testing.assert_array_equal(to_numpy(tst["bptt_overflow"]),
                                      np.asarray(jst["bptt_overflow"]))
        # an update in between: the next window is truncated BPTT from here
        new = jax.tree.map(lambda p, g: p - 0.1 * g, _tree_np(
            jlr.params_of(jc)), _tree_np(jg))
        jc = jlr.reset_grads(jc, _jtree(new))
        tc = tlr.reset_grads(tc, params_from_numpy(new, "cpu"))
        assert int(tc["pos"]) == 0 and torch.equal(tc["a0"], tc["a"])
    tc, _, _, tst = ON.stream_grads(tlr, tc, torch.from_numpy(xs[:6]),
                                    torch.from_numpy(yss[:6]))
    assert to_numpy(tst["bptt_overflow"]).tolist() == [0, 0, 0, 0, 1, 1]
    # the horizon defaults to round(t_total) and binds the learner
    fresh = make_learner(LearnerSpec(engine="bptt", cfg=l1))
    batch = (torch.from_numpy(xs[0]), torch.from_numpy(ys))
    assert fresh.init(params_from_numpy(single, "cpu"), None, batch,
                      4.0)["xbuf"].shape[0] == 4
    with pytest.raises(ValueError, match="horizon"):
        fresh.init(params_from_numpy(single, "cpu"), None, batch, 5.0)


def test_bptt_train_step_and_accuracy_match_reference():
    jcfg, cfg, params, _, xs, ys = _stacked_setup("gru", 1, T=5)
    single = dict(params["layers"][0], out=params["out"])
    from repro.optim import optimizers as JO
    jopt, opt = JO.adamw(lr=1e-2), O.adamw(lr=1e-2)
    jp, _, jloss, _ = JB.bptt_train_step(
        jcfg.layer_cfg(0), _jtree(single), jopt, jopt.init(_jtree(single)),
        (jnp.asarray(xs), jnp.asarray(ys)), jnp.int32(0))
    tsingle = params_from_numpy(single, "cpu")
    tp, _, tloss, _ = B.bptt_train_step(
        cfg.layer_cfg(0), tsingle, opt, opt.init(tsingle),
        (torch.from_numpy(xs), torch.from_numpy(ys)), 0)
    assert float(tloss) == pytest.approx(float(jloss), rel=REL)
    _assert_trees_close(tp, jp)
    logits = np.random.default_rng(0).normal(size=(9, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 2, 1, 0, 0, 1, 2], np.int32)
    assert float(C.accuracy(torch.from_numpy(logits),
                            torch.from_numpy(labels))) == \
        float(JC.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

def test_costs_match_reference_exactly():
    jcfg, cfg = JC.EGRUConfig(), C.EGRUConfig()
    sp = dict(alpha=0.6, beta=0.3, omega=0.8)
    ci, jci = CO.from_config(cfg, **sp), JCO.from_config(jcfg, **sp)
    assert dataclasses.asdict(ci) == dataclasses.asdict(jci)
    assert (ci.at, ci.bt, ci.wt) == (jci.at, jci.bt, jci.wt)
    assert CO.table1(ci) == JCO.table1(jci)
    assert CO.measured_op_count(ci, 0.4, 0.3) == \
        JCO.measured_op_count(jci, 0.4, 0.3)
    assert CO.savings_factor(0.4, 0.3, 0.8) == JCO.savings_factor(0.4, 0.3, 0.8)
    rng = np.random.default_rng(0)
    betas, prev = rng.random((5, 17)), rng.random((5, 17))
    np.testing.assert_array_equal(
        CO.compute_adjusted_iterations(betas, prev, 0.8),
        JCO.compute_adjusted_iterations(betas, prev, 0.8))
    mask = (rng.random((20, 13)) > 0.7).astype(np.float32)
    assert CO.tpu_block_factor(mask) == JCO.tpu_block_factor(mask)
    for args in ((16, 928), (16, 928, 8), (16, 928, 8, 16), (16, 928, 8, 8,
                                                            256)):
        assert CO.influence_update_flops(*args) == \
            JCO.influence_update_flops(*args)
    assert CO.influence_carry_bytes(32, 16, 640, 2) == \
        JCO.influence_carry_bytes(32, 16, 640, 2)
    kb, kp = rng.integers(0, 17, 32), rng.integers(0, 17, 32)
    assert CO.ragged_influence_update_flops(kb, kp, 640) == \
        JCO.ragged_influence_update_flops(kb, kp, 640)
    assert CO.influence_update_bytes(32, 16, 16, 640, 16, 2) == \
        JCO.influence_update_bytes(32, 16, 16, 640, 16, 2)
    assert CO.diag_influence_flops(16, 928, 0.8) == \
        JCO.diag_influence_flops(16, 928, 0.8)
    for adaptive in (True, False):
        assert CO.eprop_trace_bytes(4, 16, 2, 4, adaptive) == \
            JCO.eprop_trace_bytes(4, 16, 2, 4, adaptive)
    assert CO.live_col_fraction(244, 928) == JCO.live_col_fraction(244, 928)
    assert CO.carry_footprint(32, 16, 1024, 244) == \
        JCO.carry_footprint(32, 16, 1024, 244)
    assert CO.carry_footprint(32, 16, 1024) == JCO.carry_footprint(32, 16, 1024)
    for kw in ({}, {"betas_t": [0.3, 0.5]},
               {"betas_t": [0.3, 0.5], "betas_prev": [0.2, 0.6],
                "omegas": [0.8, 0.8]}):
        got = CO.stacked_influence_update_flops([16, 16], [928, 1600], **kw)
        want = JCO.stacked_influence_update_flops([16, 16], [928, 1600], **kw)
        assert got == want
    assert CO.stacked_savings_factor([0.3, 0.5], [0.2, 0.6], [0.8, 0.8]) == \
        JCO.stacked_savings_factor([0.3, 0.5], [0.2, 0.6], [0.8, 0.8])


def test_flat_col_density_matches_reference():
    jcfg, cfg, params, masks, _, _ = _stacked_setup("gru", 2, sparsity=0.8)
    for l in range(2):
        jl, tl = JSP.flat_layout(jcfg.layer_cfg(l)), \
            ST.SP.flat_layout(cfg.layer_cfg(l))
        tm = masks_from_numpy(masks[l], "cpu")
        assert ST.SP.flat_col_density(tl, tm) == \
            JSP.flat_col_density(jl, _jtree(masks[l]))
        assert ST.SP.flat_col_density(tl, None) == 1.0
