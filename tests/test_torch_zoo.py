"""The port's cell zoo (rgLRU, the toy diagonal cell, the SNN) and its
engines (diag_exact / diag, eprop, snap) held against the JAX package on the
same numpy params, masks and inputs, and against the port's own oracles.

Tolerances: closed-form partials and single e-prop steps within 1e-6
absolute (one step of float32 elementwise math, rounded alike up to the
libraries' transcendental functions); window gradients within 1e-5 of each
leaf's largest magnitude (float32 sums over the window, associated
differently by the two libraries and by the forward and reverse modes);
e-prop against the surrogate BPTT oracle by cosine >= 0.9 (the reference's
own bar: e-prop is an approximation).  Inside the port, streaming against
the whole-sequence scan is bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cells import rglru as JR, snn as JS
from repro.core import cells as JC, diag_rtrl as JD, learner as JL
from repro.core import snap as JSN, sparse_rtrl as JSP
from repro_torch.cells import CELLS, Cell, make_cell, resolve_cell
from repro_torch.cells import rglru as R, snn as S
from repro_torch.core import cells as C, diag_rtrl as D, snap as SN
from repro_torch.core.learner import LearnerSpec, make_learner, scan_learner
from repro_torch.weights import masks_from_numpy, params_from_numpy, to_numpy

REL = 1e-5
ATOL = 1e-6


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


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_trees_close(got, want, rel=REL):
    got = jax.tree.leaves(to_numpy(got))
    want = jax.tree.leaves(_np(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale)


def _assert_trees_bitwise(a, b):
    la, lb = jax.tree.leaves(to_numpy(a)), jax.tree.leaves(to_numpy(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def _cos(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# the JAX and port configs of each zoo cell, at a small size
_CFGS = {
    "rglru": (JR.RGLRUCellConfig(n=8, n_in=3, n_out=2),
              R.RGLRUCellConfig(n=8, n_in=3, n_out=2)),
    "diag": (JD.DiagCellConfig(n=8, n_in=3, n_out=2),
             D.DiagCellConfig(n=8, n_in=3, n_out=2)),
    "snn": (JS.SNNConfig(n=16, n_in=4, n_out=2),
            S.SNNConfig(n=16, n_in=4, n_out=2)),
}
_JINIT = {"rglru": JR.init_params, "diag": JD.init_params,
          "snn": JS.init_params}


def _setup(name, seed=0, T=7, B=4, sparsity=None, x_scale=1.0):
    """JAX-drawn params (masked by JAX-drawn masks at `sparsity`), numpy
    inputs xs [T, B, n_in] and labels [B]."""
    jcfg, cfg = _CFGS[name]
    params = _JINIT[name](jcfg, jax.random.key(seed))
    masks = None
    if sparsity is not None:
        masks = JR.make_masks(jcfg, jax.random.key(seed + 7), sparsity)
        params = JR.apply_masks(params, masks)
        masks = _np(masks)
    rng = np.random.default_rng(seed + 1)
    xs = (x_scale * rng.normal(size=(T, B, jcfg.n_in))).astype(np.float32)
    labels = np.array([i % jcfg.n_out for i in range(B)], np.int32)
    return jcfg, cfg, _np(params), masks, xs, labels


def _both_scans(engine, jcfg, cfg, params, masks, xs, labels, **kw):
    jl = JL.make_learner(JL.LearnerSpec(engine=engine, cfg=jcfg, **kw))
    jloss, jgrads, _ = JL.scan_learner(
        jl, _j(params), None if masks is None else _j(masks),
        jnp.asarray(xs), jnp.asarray(labels))
    tl = make_learner(LearnerSpec(engine=engine, cfg=cfg, **kw))
    tloss, tgrads, _ = scan_learner(
        tl, params_from_numpy(params, "cpu"),
        None if masks is None else masks_from_numpy(masks, "cpu"),
        _t(xs), _t(labels))
    return (float(jloss), jgrads), (float(tloss), tgrads)


# --- the protocol ------------------------------------------------------------

def test_every_cell_satisfies_protocol():
    cfgs = {"egru": C.EGRUConfig(n_hidden=8, n_in=3, n_out=2),
            "rglru": _CFGS["rglru"][1], "snn": _CFGS["snn"][1],
            "diag": _CFGS["diag"][1]}
    assert set(CELLS) == set(cfgs)
    for name, cfg in cfgs.items():
        cell = make_cell(name, cfg)
        assert isinstance(cell, Cell), name
        assert cell.name == name and cell.cfg is cfg
        assert cell.jac_kind in ("dense", "diagonal"), name
        assert resolve_cell(cfg).__class__ is cell.__class__, name
        params = cell.init_params(torch.Generator().manual_seed(0),
                                  device="cpu")
        assert "out" not in cell.rec_params(params), name
        state = cell.init_state(3, device="cpu")
        logits = cell.readout(params, state)
        assert logits.shape == (3, 2), name
        assert not cell.activity_mask(state).any(), name
    with pytest.raises(ValueError):
        make_cell("nope", cfgs["egru"])
    with pytest.raises(ValueError):
        resolve_cell(object())
    with pytest.raises(NotImplementedError, match="eprop"):
        make_cell("snn", cfgs["snn"]).partials(None, None, None)


@pytest.mark.parametrize("name", ["rglru", "diag", "snn"])
def test_init_params_follow_the_reference_layout(name):
    """Same tree structure, shapes and dtypes as the reference's init;
    lam drawn in [2.2, 5.5] and the readout bias 0."""
    jcfg, cfg = _CFGS[name]
    want = _np(_JINIT[name](jcfg, jax.random.key(0)))
    got = to_numpy(make_cell(name, cfg).init_params(
        torch.Generator().manual_seed(0), device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    if "lam" in got:
        assert 2.2 <= got["lam"].min() and got["lam"].max() <= 5.5
    assert (got["out"]["b"] == 0).all()


# --- closed-form partials ----------------------------------------------------

@pytest.mark.parametrize("name", ["rglru", "diag"])
def test_diagonal_partials_match_reference(name):
    jcfg, cfg, params, _, xs, _ = _setup(name)
    h0 = np.random.default_rng(2).normal(size=(4, cfg.n)).astype(np.float32)
    w = {k: v for k, v in params.items() if k != "out"}
    jmod, tmod = (JR, R) if name == "rglru" else (JD, D)
    want = jmod.cell_partials(jcfg, _j(w), jnp.asarray(h0), jnp.asarray(xs[0]))
    got = tmod.cell_partials(cfg, params_from_numpy(w, "cpu"), _t(h0),
                             _t(xs[0]))
    for g, wt in zip(jax.tree.leaves(to_numpy(list(got))),
                     jax.tree.leaves(_np(list(want)))):
        np.testing.assert_allclose(g, wt, rtol=0, atol=ATOL)
    # the step is the partials' state
    np.testing.assert_allclose(
        to_numpy(tmod.step(cfg, params_from_numpy(w, "cpu"), _t(h0),
                           _t(xs[0]))),
        np.asarray(want[0]), rtol=0, atol=ATOL)
    if name == "diag":
        _, tr = D.trace_update(cfg, params_from_numpy(w, "cpu"),
                               D.init_traces(cfg, 4, device="cpu"), _t(h0),
                               _t(xs[0]))
        _, jtr = JD.trace_update(jcfg, _j(w), JD.init_traces(jcfg, 4),
                                 jnp.asarray(h0), jnp.asarray(xs[0]))
        _assert_trees_close(tr, jtr)


def test_softplus_is_the_reference_form():
    """logaddexp(x, 0), with no threshold: above torch's default threshold
    of 20 F.softplus returns x itself."""
    x = np.array([-30.0, -3.0, 0.0, 2.2, 5.5, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_array_equal(to_numpy(D.softplus(_t(x))),
                                  np.asarray(jax.nn.softplus(jnp.asarray(x))))


def test_rglru_mbar_matches_jacrev_diagonal():
    """The closed-form trace increments equal the diagonal slice of the
    one-step Jacobian by torch.func.jacrev, and dh_new/dh_prev is exactly
    diag(a)."""
    _, cfg, params, _, xs, _ = _setup("rglru")
    h0 = torch.from_numpy(
        np.random.default_rng(2).normal(size=(4, cfg.n)).astype(np.float32))
    w = {k: v for k, v in params_from_numpy(params, "cpu").items()
         if k != "out"}
    x0 = _t(xs[0])
    h_new, hp, adiag, mbar = R.cell_partials(cfg, w, h0, x0)
    np.testing.assert_allclose(to_numpy(h_new),
                               to_numpy(R.step(cfg, w, h0, x0)), atol=1e-7)
    assert bool((hp == 1).all())
    J = torch.func.jacrev(lambda ww: R.step(cfg, ww, h0, x0))(w)
    for k in ("Wx", "Wi", "Wa"):
        diag = np.einsum("bkjk->bjk", J[k].numpy())          # [B,n_in,n]
        np.testing.assert_allclose(mbar[k].numpy(), diag, atol=1e-6)
    np.testing.assert_allclose(mbar["lam"].numpy(),
                               np.einsum("bkk->bk", J["lam"].numpy()),
                               atol=1e-6)
    Jh = torch.func.jacrev(lambda h: R.step(cfg, w, h, x0))(h0).numpy()
    np.testing.assert_allclose(np.einsum("bkbk->bk", Jh), adiag.numpy(),
                               atol=1e-6)


def test_snn_steps_match_reference():
    """From a live state and live traces: the surrogate step, the
    membrane and one e-prop step (state, traces, eligibilities)."""
    jcfg, cfg, params, _, xs, _ = _setup("snn", x_scale=1.5)
    w = {k: v for k, v in params.items() if k != "out"}
    rng = np.random.default_rng(5)
    B, n, n_in = 4, cfg.n, cfg.n_in
    state = {"v": rng.normal(size=(B, n)), "z": rng.random((B, n)) < 0.3,
             "b": rng.random((B, n)), "psi": 0.3 * rng.random((B, n))}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    tr = {"v_in": rng.normal(size=(B, n_in)), "v_rec": rng.random((B, n)),
          "a_in": rng.normal(size=(B, n_in, n)),
          "a_rec": rng.normal(size=(B, n, n))}
    tr = {k: v.astype(np.float32) for k, v in tr.items()}
    tw, ts, ttr = (params_from_numpy(t, "cpu") for t in (w, state, tr))
    got = S.eprop_step(cfg, tw, ts, ttr, _t(xs[0]))
    want = JS.eprop_step(jcfg, _j(w), _j(state), _j(tr), jnp.asarray(xs[0]))
    for g, wt in zip(got, want):
        assert sorted(g) == sorted(wt)
        for k in g:
            np.testing.assert_allclose(to_numpy(g[k]), np.asarray(wt[k]),
                                       rtol=0, atol=ATOL)
    st = S.step_st(cfg, tw, ts, _t(xs[0]))
    jst = JS.step_st(jcfg, _j(w), _j(state), jnp.asarray(xs[0]))
    for k in st:
        np.testing.assert_allclose(to_numpy(st[k]), np.asarray(jst[k]),
                                   rtol=0, atol=ATOL)
    np.testing.assert_array_equal(to_numpy(st["z"]), to_numpy(got[0]["z"]))


def test_snn_spike_surrogate_under_torch_func():
    """The spike's backward is psi(u) through autograd, torch.func.jacrev
    and torch.func.vmap (the reference's custom_jvp)."""
    cfg = _CFGS["snn"][1]
    u = torch.linspace(-1.0, 1.0, 41)
    psi = S.pseudo_derivative(cfg, u)
    spike = lambda v: S._SpikeST.apply(v, cfg.gamma, cfg.v_th)
    np.testing.assert_array_equal(spike(u).numpy(), (u > 0).float().numpy())
    J = torch.func.jacrev(spike)(u)
    np.testing.assert_array_equal(torch.diagonal(J).numpy(), psi.numpy())
    assert float((J - torch.diag(torch.diagonal(J))).abs().max()) == 0.0
    g = torch.func.vmap(torch.func.grad(lambda v: spike(v).sum()))(
        u[:, None])
    np.testing.assert_array_equal(g[:, 0].numpy(), psi.numpy())
    v = u.clone().requires_grad_(True)
    (gv,) = torch.autograd.grad(spike(v).sum(), v)
    np.testing.assert_array_equal(gv.numpy(), psi.numpy())


# --- exact diagonal traces ---------------------------------------------------

@pytest.mark.parametrize("name,sparsity", [("rglru", None), ("rglru", 0.5),
                                           ("diag", None)])
@pytest.mark.parametrize("engine", ["diag_exact", "diag"])
def test_diag_exact_matches_bptt_and_reference(name, sparsity, engine):
    jcfg, cfg, params, masks, xs, labels = _setup(name, sparsity=sparsity)
    (jloss, jgrads), (tloss, tgrads) = _both_scans(
        engine, jcfg, cfg, params, masks, xs, labels)
    assert tloss == pytest.approx(jloss, rel=REL)
    _assert_trees_close(tgrads, jgrads)
    oracle = (R if name == "rglru" else D).bptt_loss_and_grads
    bloss, bgrads = oracle(cfg, params_from_numpy(params, "cpu"), _t(xs),
                           _t(labels))
    assert tloss == pytest.approx(float(bloss), rel=REL)
    if masks is not None:
        # fixed masks: the oracle's gradients at dead positions are not
        # trained; the engine's are exactly 0
        bgrads = {k: (v * masks_from_numpy(masks, "cpu")[k] if k in masks
                      else v) for k, v in bgrads.items()}
        for k in ("Wx", "Wi", "Wa"):
            dead = masks[k] == 0.0
            assert (to_numpy(tgrads[k])[dead] == 0.0).all(), k
    _assert_trees_close(tgrads, to_numpy(bgrads))


def test_diag_engine_aliases_share_one_implementation():
    _, cfg, params, _, xs, labels = _setup("diag")
    p = params_from_numpy(params, "cpu")
    runs = [scan_learner(make_learner(LearnerSpec(engine=e, cfg=cfg)), p,
                         None, _t(xs), _t(labels)) for e in ("diag",
                                                             "diag_exact")]
    assert float(runs[0][0]) == float(runs[1][0])
    _assert_trees_bitwise(runs[0][1], runs[1][1])
    loss, grads = D.rtrl_loss_and_grads(cfg, p, _t(xs), _t(labels))
    assert float(loss) == float(runs[0][0])
    _assert_trees_bitwise(grads, runs[0][1])
    carry = make_learner(LearnerSpec(engine="diag", cfg=cfg)).init(
        p, None, (_t(xs[0]), _t(labels)), t_total=4)
    assert {"h", "tr", "gw", "gout"} <= set(carry)
    assert set(carry["gw"]) == {"Wx", "Wa", "lam"}
    with pytest.raises(ValueError, match="diagonal"):
        make_learner(LearnerSpec(engine="diag_exact",
                                 cfg=C.EGRUConfig(n_hidden=4)))


# --- e-prop ------------------------------------------------------------------

def test_eprop_matches_reference_steps_and_window():
    """Each step's own gradient term (per_step_grads) and the window's
    accumulated gradients, loss and stats against the JAX EpropLearner."""
    jcfg, cfg, params, _, xs, labels = _setup("snn", T=8, x_scale=1.5)
    jl = JL.make_learner(JL.LearnerSpec(engine="eprop", cfg=jcfg,
                                        per_step_grads=True))
    tl = make_learner(LearnerSpec(engine="eprop", cfg=cfg,
                                  per_step_grads=True))
    jc = jl.init(_j(params), None, (jnp.asarray(xs[0]),
                                    jnp.asarray(labels)), t_total=8.0)
    tc = tl.init(params_from_numpy(params, "cpu"), None,
                 (_t(xs[0]), _t(labels)), t_total=8.0)
    for t in range(xs.shape[0]):
        jc, jout = jl.step(jc, jnp.asarray(xs[t]), jnp.asarray(labels))
        tc, tout = tl.step(tc, _t(xs[t]), _t(labels))
        assert float(tout.loss) == pytest.approx(float(jout.loss), rel=REL)
        _assert_trees_close(tout.grads, jout.grads)
        np.testing.assert_allclose(to_numpy(tout.readout),
                                   np.asarray(jout.readout), atol=1e-5)
        assert float(tout.stats["alpha"]) == float(jout.stats["alpha"])
        _assert_trees_close(tc["h"], jc["h"])
        _assert_trees_close(tc["tr"], jc["tr"])
    assert float(tc["loss"]) == pytest.approx(float(jc["loss"]), rel=REL)
    _assert_trees_close(tl.grads(tc), jl.grads(jc))


@pytest.mark.parametrize("seed", [0, 1])
def test_eprop_aligns_with_surrogate_bptt(seed):
    """e-prop's W and R gradients have cosine >= 0.9 with the surrogate
    BPTT oracle's; the readout's gradient (no approximation there) and the
    loss agree to float32."""
    jcfg, cfg, params, _, xs, labels = _setup("snn", seed=seed, T=12,
                                              x_scale=1.5)
    (jloss, jgrads), (tloss, tgrads) = _both_scans(
        "eprop", jcfg, cfg, params, None, xs, labels)
    assert tloss == pytest.approx(jloss, rel=REL)
    _assert_trees_close(tgrads, jgrads)
    bloss, bgrads = S.bptt_loss_and_grads(cfg, params_from_numpy(params,
                                                                 "cpu"),
                                          _t(xs), _t(labels))
    assert tloss == pytest.approx(float(bloss), rel=REL)
    for k in ("W", "R"):
        assert _cos(to_numpy(tgrads[k]), to_numpy(bgrads[k])) >= 0.9, k
    _assert_trees_close(tgrads["out"], to_numpy(bgrads["out"]))
    jb = JS.bptt_loss_and_grads(jcfg, _j(params), jnp.asarray(xs),
                                jnp.asarray(labels))
    _assert_trees_close(bgrads, jb[1])


def test_eprop_traces_have_the_eprop_structure():
    """Rank-1 membrane traces, full adaptation traces; from rest the first
    step's eligibility is psi * eps_v."""
    _, cfg, params, _, xs, _ = _setup("snn", x_scale=1.5)
    B = xs.shape[1]
    tr = S.init_eprop_traces(cfg, B, device="cpu")
    assert tuple(tr["v_in"].shape) == (B, cfg.n_in)
    assert tuple(tr["v_rec"].shape) == (B, cfg.n)
    assert tuple(tr["a_in"].shape) == (B, cfg.n_in, cfg.n)
    w = {k: v for k, v in params_from_numpy(params, "cpu").items()
         if k != "out"}
    state2, tr2, e = S.eprop_step(cfg, w, S.init_state(cfg, B, device="cpu"),
                                  tr, _t(xs[0]))
    assert tuple(e["R"].shape) == (B, cfg.n, cfg.n)
    want = state2["psi"][:, None, :] * tr2["v_in"][:, :, None]
    np.testing.assert_allclose(e["W"].numpy(), want.numpy(), atol=1e-6)
    from repro_torch.core import costs
    assert costs.eprop_trace_bytes(B, cfg.n, cfg.n_in) == sum(
        t.numel() * 4 for t in tr.values())


# --- SnAp --------------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2])
def test_snap_matches_reference(order):
    jcfg = JC.EGRUConfig(n_hidden=8, n_in=3, n_out=2, kind="gru")
    cfg = C.EGRUConfig(n_hidden=8, n_in=3, n_out=2, kind="gru")
    masks = JSP.make_masks(jcfg, jax.random.key(7), 0.5)
    params = _np(JSP.apply_masks(JC.init_params(jcfg, jax.random.key(0)),
                                 masks))
    masks = _np(masks)
    rng = np.random.default_rng(1)
    xs = (2.0 * rng.normal(size=(7, 4, 3))).astype(np.float32)
    labels = np.array([i % 2 for i in range(4)], np.int32)
    tp, tm = params_from_numpy(params, "cpu"), masks_from_numpy(masks, "cpu")
    np.testing.assert_array_equal(
        SN.snap2_pattern(cfg, tm).numpy(),
        np.asarray(JSN.snap2_pattern(jcfg, _j(masks))))
    np.testing.assert_array_equal(SN.snap2_pattern(cfg, None).numpy(),
                                  np.ones((8, 8), np.float32))
    jloss, jgrads, jst = JSN.snap_loss_and_grads(
        jcfg, _j(params), jnp.asarray(xs), jnp.asarray(labels), order=order,
        masks=_j(masks))
    tloss, tgrads, tst = SN.snap_loss_and_grads(cfg, tp, _t(xs), _t(labels),
                                                order=order, masks=tm)
    assert float(tloss) == pytest.approx(float(jloss), rel=REL)
    _assert_trees_close(tgrads, jgrads)
    assert float(tst["beta"]) == pytest.approx(float(jst["beta"]), abs=1e-7)
    assert float(tst["keep_density"]) == float(jst["keep_density"])
    # the streaming learner, stepped by hand, against the JAX one
    (jl2, jg2), (tl2, tg2) = _both_scans("snap", jcfg, cfg, params, masks,
                                         xs, labels, order=order)
    assert tl2 == float(tloss)
    _assert_trees_bitwise(tg2, tgrads)
    _assert_trees_close(tg2, jg2)


def test_snap_orders_are_approximations_ordered_by_reach():
    """SnAp-1 keeps only the diagonal; SnAp-2 keeps at least it, and the
    exact engine's gradients sit nearer SnAp-2's than SnAp-1's."""
    cfg = C.EGRUConfig(n_hidden=8, n_in=3, n_out=2, kind="gru")
    p = C.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    xs = torch.from_numpy(np.random.default_rng(3).normal(
        size=(9, 4, 3)).astype(np.float32)) * 2
    labels = torch.tensor([0, 1, 0, 1])
    _, g1, s1 = SN.snap_loss_and_grads(cfg, p, xs, labels, order=1)
    _, g2, s2 = SN.snap_loss_and_grads(cfg, p, xs, labels, order=2)
    assert float(s1["keep_density"]) == 1.0 / 8
    assert float(s2["keep_density"]) == 1.0        # no masks: all reach
    exact = scan_learner(make_learner(LearnerSpec(engine="sparse", cfg=cfg)),
                         p, None, xs, labels)[1]
    gap = lambda g: sum(float((g[k]["R"] - exact[k]["R"]).norm())
                        for k in ("u", "r", "z"))
    assert gap(g2) <= gap(g1)
    assert gap(g2) < 1e-5 * max(1.0, gap(g1))      # full pattern: exact


# --- streaming against the whole-sequence scan, bitwise -----------------------

@pytest.mark.parametrize("engine,name", [("diag_exact", "rglru"),
                                         ("eprop", "snn")])
def test_streaming_equals_scan_bitwise(engine, name):
    """One step at a time from stream-shaped inputs (each x_t its own
    tensor, as the online trainer hands them over) replays the
    whole-sequence scan bit for bit: the loss and every gradient leaf."""
    _, cfg, params, masks, xs, labels = _setup(
        name, sparsity=0.5 if name == "rglru" else None, x_scale=1.5)
    p = params_from_numpy(params, "cpu")
    m = None if masks is None else masks_from_numpy(masks, "cpu")
    spec = LearnerSpec(engine=engine, cfg=cfg)
    loss, grads, _ = scan_learner(make_learner(spec), p, m, _t(xs),
                                  _t(labels))
    learner = make_learner(spec)
    carry = learner.init(p, m, (_t(xs[0]), _t(labels)), t_total=xs.shape[0])
    for t in range(xs.shape[0]):
        carry, _ = learner.step(carry, _t(xs[t].copy()), _t(labels.copy()))
    assert float(carry["loss"]) == float(loss)
    _assert_trees_bitwise(learner.grads(carry), grads)


def test_learners_refuse_the_wrong_cell():
    with pytest.raises(ValueError, match="eprop_step"):
        make_learner(LearnerSpec(engine="eprop", cfg=_CFGS["rglru"][1]))
    with pytest.raises(ValueError, match="diagonal"):
        make_learner(LearnerSpec(engine="diag_exact", cfg=_CFGS["snn"][1]))


# --- the window oracle -------------------------------------------------------

@pytest.mark.parametrize("name", ["rglru", "diag", "snn", "egru"])
def test_window_bptt_equals_the_sequence_oracles(name):
    """`bptt.window_bptt_loss_and_grads` (a label a step, any cell) at a
    label fixed over the window is each cell's own sequence oracle."""
    from repro_torch.core import bptt as BP
    if name == "egru":
        cfg = C.EGRUConfig(n_hidden=8, n_in=3, n_out=2)
        p = C.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        rng = np.random.default_rng(1)
        xs = (2.0 * rng.normal(size=(7, 4, 3))).astype(np.float32)
        labels = np.array([0, 1, 0, 1], np.int32)
        want = BP.bptt_loss_and_grads(cfg, p, _t(xs), _t(labels))[:2]
    else:
        _, cfg, params, _, xs, labels = _setup(name, x_scale=1.5)
        p = params_from_numpy(params, "cpu")
        want = {"rglru": R, "diag": D, "snn": S}[name].bptt_loss_and_grads(
            cfg, p, _t(xs), _t(labels))
    ys = np.broadcast_to(labels, (xs.shape[0],) + labels.shape)
    loss, grads = BP.window_bptt_loss_and_grads(resolve_cell(cfg), p, _t(xs),
                                                _t(ys))
    assert float(loss) == pytest.approx(float(want[0]), rel=REL)
    _assert_trees_close(grads, to_numpy(want[1]))
