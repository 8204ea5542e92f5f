"""The port's stacked engine (L >= 2) held against the JAX package on the
same numpy params, masks and inputs, and against the port's own oracles:
the stacked layout helpers, the offset M-bar builders, the row-compact
kernels, one layer's compact step with the cross-layer term, and the
whole-sequence `stacked_rtrl_loss_and_grads` with every backend.

Tolerances: losses agree to 1e-5 relative, gradients and influence values
to 1e-5 of the largest magnitude of their tree or array (float32 sums
associated differently by the two libraries); layouts, indices, counts
and overflow agree exactly; inside the port the stream path equals the
whole-sequence path bit for bit.  The JAX package's `pallas` backend runs
its kernel in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cells import egru as JE
from repro.core import cells as JC, learner as JL
from repro.core import sparse_rtrl as JSP, stacked_rtrl as JST
from repro.kernels import compact as JCK
from repro_torch.cells import egru as E
from repro_torch.core import bptt as B, cells as C, rtrl as R
from repro_torch.core import sparse_rtrl as SP, stacked_rtrl as ST
from repro_torch.core.learner import LearnerSpec, make_learner
from repro_torch.kernels import compact as CK
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


def _close(got, want, rel=REL, err_msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, err_msg
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=err_msg)


def _assert_trees_close(got, want, rel=REL):
    """Every leaf within rel of the tree's largest magnitude."""
    got = jax.tree.leaves(to_numpy(got))
    want = jax.tree.leaves(_tree_np(want))
    assert len(got) == len(want)
    scale = max(max(float(np.abs(w).max()) for w in want), 1e-3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale)


def _setup(kind, L, *, sparsity=0.6, T=5, B=4, n_in=3, seed=0):
    """JAX-drawn stacked params and masks (layers of 8, 6 and 10 units) as
    numpy, and a sequence with per-example input scales (ragged activity)."""
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


def _pmasks(masks):
    return [masks_from_numpy(m, "cpu") for m in masks]


def _survivors(grads, masks):
    """The gradient on surviving parameters only (BPTT also gives pruned
    ones a gradient, which the masked optimizer drops)."""
    return ST.apply_stacked_masks(grads, masks)


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def test_stacked_layout_helpers_match_reference():
    jcfg, cfg, _, masks, _, _ = _setup("gru", 3)
    jsl, sl = JST.stacked_layout(jcfg), ST.stacked_layout(cfg)
    assert (sl.offsets, sl.P_total, sl.P_pad, sl.n_layers) == \
        (jsl.offsets, jsl.P_total, jsl.P_pad, jsl.n_layers)
    assert [sl.layer_slice(l) for l in range(3)] == \
        [jsl.layer_slice(l) for l in range(3)]
    pm = _pmasks(masks)
    colm = ST.stacked_col_mask(sl, pm, device="cpu")
    for got, want in zip(ST.layer_col_masks(sl, colm),
                         JST.layer_col_masks(jsl, JST.stacked_col_mask(
                             jsl, _jtree(masks)))):
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    cl = ST.stacked_col_layout(sl, pm, device="cpu")
    jcl = JST.stacked_col_layout(jsl, _jtree(masks))
    assert (cl.Pc, cl.Pc_pad, cl.P_pad) == (jcl.Pc, jcl.Pc_pad, jcl.P_pad)
    for f in ("src", "layer", "gate", "q", "j", "live"):
        np.testing.assert_array_equal(to_numpy(getattr(cl, f)),
                                      np.asarray(getattr(jcl, f)), err_msg=f)
    for got, want in zip(ST.layer_col_lives(sl, cl),
                         JST.layer_col_lives(jsl, jcl)):
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    gw = np.random.default_rng(0).normal(size=(sl.P_pad,)).astype(np.float32)
    got = ST.unflatten_stacked_grads(cfg, sl, torch.from_numpy(gw))
    want = JST.unflatten_stacked_grads(jcfg, jsl, jnp.asarray(gw))
    for g, w in zip(jax.tree.leaves(to_numpy(got)),
                    jax.tree.leaves(_tree_np(want))):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the offset M-bar builders and the row-compact kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gru", "rnn"])
def test_flat_mbar_with_offset_and_rows_match_reference(kind):
    """Layer 1 of a two-layer stack: M-bar placed at its column offset in
    the stacked axis, full rows and gathered rows, with the column mask."""
    jcfg, cfg, params, masks, _, _ = _setup(kind, 2)
    jsl, sl = JST.stacked_layout(jcfg), ST.stacked_layout(cfg)
    rng = np.random.default_rng(2)
    a = (rng.random((4, 6)) > 0.5).astype(np.float32)
    x = (rng.random((4, 8)) > 0.4).astype(np.float32)
    _, _, _, _, jm = JE.cell_partials_full(
        jcfg.layer_cfg(1), _jtree(params["layers"][1]), jnp.asarray(a),
        jnp.asarray(x))
    _, _, _, _, m = E.cell_partials_full(
        cfg.layer_cfg(1), params_from_numpy(params, "cpu")["layers"][1],
        torch.from_numpy(a), torch.from_numpy(x))
    jcm = JST.layer_col_masks(jsl, JST.stacked_col_mask(jsl, _jtree(masks)))
    cm = ST.layer_col_masks(sl, ST.stacked_col_mask(sl, _pmasks(masks),
                                                    device="cpu"))
    safe = rng.integers(0, 6, (4, 8)).astype(np.int32)
    lcfg, jlcfg = cfg.layer_cfg(1), jcfg.layer_cfg(1)
    place = dict(offset=sl.offsets[1], total_pad=sl.P_pad)
    got = SP.flat_mbar(lcfg, sl.layers[1], m, cm[1], **place)
    want = JSP.flat_mbar(jlcfg, jsl.layers[1], jm, jcm[1], **place)
    _close(to_numpy(got), want, err_msg="flat_mbar")
    got = SP.flat_mbar_rows(lcfg, sl.layers[1], m, torch.from_numpy(safe),
                            cm[1], **place)
    want = JSP.flat_mbar_rows(jlcfg, jsl.layers[1], jm, jnp.asarray(safe),
                              jcm[1], **place)
    _close(to_numpy(got), want, err_msg="flat_mbar_rows")
    assert tuple(got.shape) == (4, 8, sl.P_pad)
    # no offset: the layer's own width, no mask
    got = SP.flat_mbar_rows(lcfg, sl.layers[1], m, torch.from_numpy(safe))
    want = JSP.flat_mbar_rows(jlcfg, jsl.layers[1], jm, jnp.asarray(safe))
    _close(to_numpy(got), want, err_msg="flat_mbar_rows, own width")
    # the stacked compact axis: layer 1's M-bar only at layer 1's columns
    cl = ST.stacked_col_layout(sl, _pmasks(masks), device="cpu")
    cols = SP.flat_mbar_rows_cols(lcfg, sl.layers[1], cl, m,
                                  torch.from_numpy(safe), layer=1)
    assert bool((cols[:, :, cl.layer != 1] == 0).all())
    _close(to_numpy(SP.cols_to_flat(cl, cols)), to_numpy(
        SP.flat_mbar_rows(lcfg, sl.layers[1], m, torch.from_numpy(safe),
                          ST.stacked_col_mask(sl, _pmasks(masks),
                                              device="cpu"), **place)))


def test_compact_init_step_and_to_dense_match_reference():
    rng = np.random.default_rng(4)
    Bn, n, P, K = 3, 12, 40, 8
    Mc = CK.compact_init(Bn, K, P, device="cpu")
    jMc = JCK.compact_init(Bn, K, P)
    for g, w in zip(Mc, jMc):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
        assert to_numpy(g).dtype == np.asarray(w).dtype
    for t in range(4):
        hp = rng.random((Bn, n)).astype(np.float32)
        hp[rng.random((Bn, n)) < 0.5] = 0.0
        hp[0, :10] = 0.5 + t             # example 0 overflows K = 8
        J = rng.normal(size=(Bn, n, n)).astype(np.float32)
        Mbar = rng.normal(size=(Bn, n, P)).astype(np.float32)
        Mc, ov = CK.compact_influence_step(
            torch.from_numpy(hp), torch.from_numpy(J), Mc,
            torch.from_numpy(Mbar), K)
        jMc, jov = JCK.compact_influence_step(
            jnp.asarray(hp), jnp.asarray(J), jMc, jnp.asarray(Mbar), K)
        np.testing.assert_array_equal(to_numpy(Mc.idx), np.asarray(jMc.idx))
        np.testing.assert_array_equal(to_numpy(Mc.count),
                                      np.asarray(jMc.count))
        np.testing.assert_array_equal(to_numpy(ov), np.asarray(jov))
        _close(to_numpy(Mc.vals), jMc.vals, err_msg=f"vals step {t}")
        _close(to_numpy(CK.compact_to_dense(Mc, n)),
               JCK.compact_to_dense(jMc, n), err_msg=f"dense step {t}")
    assert int(ov[0]) > 0                # the overflow is counted
    with pytest.raises(ValueError, match="sentinel"):
        CK.compact_to_dense(Mc._replace(idx=Mc.idx.clone().fill_(n)), n)


# ---------------------------------------------------------------------------
# one layer's compact step with the cross-layer term
# ---------------------------------------------------------------------------

def _carry_after(jcfg, params, masks, xs, col):
    """The JAX compact stacked learner's carry after a few steps."""
    jl = JL.make_learner(JL.LearnerSpec(engine="stacked", cfg=jcfg,
                                        backend="compact", col_compact=col))
    c = jl.init(_jtree(params), _jtree(masks),
                (jnp.asarray(xs[0]), jnp.zeros(xs.shape[1], jnp.int32)), 4.0)
    for x in xs:
        c, _ = jl.step(c, jnp.asarray(x), jnp.zeros(xs.shape[1], jnp.int32))
    return _tree_np(c)


@pytest.mark.parametrize("kind,col", [("gru", True), ("rnn", False)])
def test_layer_step_with_below_matches_reference(kind, col):
    """Layer 1 of two from the JAX learner's carry: the compact step with
    `below` (column-compact or full width with its offset) and the fused
    step with the cross term folded into M-bar, against the JAX compact
    step and the JAX fused kernel (interpret mode)."""
    jcfg, cfg, params, masks, xs, _ = _setup(kind, 2)
    c = _carry_after(jcfg, params, masks, xs[:3], col)
    assert all((i >= 0).sum() > 0 for i in c["idx"])     # a live carry
    jsl, sl = JST.stacked_layout(jcfg), ST.stacked_layout(cfg)
    jcl = JST.stacked_col_layout(jsl, _jtree(masks)) if col else None
    cl = ST.stacked_col_layout(sl, _pmasks(masks), device="cpu") \
        if col else None
    jcm = JST.layer_col_masks(jsl, JST.stacked_col_mask(jsl, _jtree(masks)))
    cm = ST.layer_col_masks(sl, ST.stacked_col_mask(sl, _pmasks(masks),
                                                    device="cpu"))
    # the step's input is layer 0's fresh activity, below its fresh carry
    w0, jw0 = params_from_numpy(params, "cpu")["layers"][0], \
        _jtree(params["layers"][0])
    below_np = JSP.flat_compact_step(
        jcfg.layer_cfg(0), jw0, jsl.layers[0], jnp.asarray(c["a"][0]),
        jnp.asarray(c["vals"][0]), jnp.asarray(c["idx"][0]),
        jnp.asarray(xs[3]), None if col else jcm[0], offset=0,
        total_pad=jsl.P_pad, cl=jcl, layer=0)
    inp, vb, ib = (np.array(below_np[i]) for i in (0, 2, 3))
    w1, jw1 = params_from_numpy(params, "cpu")["layers"][1], \
        _jtree(params["layers"][1])
    jargs = (jnp.asarray(c["a"][1]), jnp.asarray(c["vals"][1]),
             jnp.asarray(c["idx"][1]), jnp.asarray(inp))
    jbelow = (jnp.asarray(vb), jnp.asarray(ib))
    want = [JSP.flat_compact_step(
        jcfg.layer_cfg(1), jw1, jsl.layers[1], *jargs,
        None if col else jcm[1], offset=jsl.offsets[1], total_pad=jsl.P_pad,
        below=jbelow, cl=jcl, layer=1)]
    targs = [torch.from_numpy(np.array(t)) for t in
             (c["a"][1], c["vals"][1], c["idx"][1], inp)]
    tbelow = (torch.from_numpy(vb), torch.from_numpy(ib))
    got = [SP.flat_compact_step(
        cfg.layer_cfg(1), w1, sl.layers[1], *targs, None if col else cm[1],
        offset=sl.offsets[1], total_pad=sl.P_pad, below=tbelow, cl=cl,
        layer=1)]
    if col:
        want.append(JSP.flat_compact_fused_step(
            jcfg.layer_cfg(1), jw1, jsl.layers[1], *jargs, below=jbelow,
            cl=jcl, layer=1, use_kernel=True, interpret=True))
        got.append(SP.flat_compact_fused_step(
            cfg.layer_cfg(1), w1, sl.layers[1], *targs, cl=cl, layer=1,
            below=tbelow))
    for g in got:
        for wv in want:
            a1, hp1, v1, i1, c1, o1 = g
            a2, hp2, v2, i2, c2, o2 = wv
            np.testing.assert_array_equal(to_numpy(a1), np.asarray(a2))
            _close(to_numpy(hp1), hp2)
            np.testing.assert_array_equal(to_numpy(i1), np.asarray(i2))
            np.testing.assert_array_equal(to_numpy(c1), np.asarray(c2))
            np.testing.assert_array_equal(to_numpy(o1), np.asarray(o2))
            _close(to_numpy(v1), v2, err_msg="vals")
    # the cross term is live: without it the step differs
    alone = SP.flat_compact_step(
        cfg.layer_cfg(1), w1, sl.layers[1], *targs, None if col else cm[1],
        offset=sl.offsets[1], total_pad=sl.P_pad, cl=cl, layer=1)
    assert not torch.allclose(alone[2], got[0][2])


# ---------------------------------------------------------------------------
# the whole-sequence engine, every backend
# ---------------------------------------------------------------------------

_ENGINE_CASES = [(b, L, k, None) for b in ("dense", "pallas", "compact",
                                           "compact_fused")
                 for L, k in ((2, "gru"), (3, "rnn"))] + \
    [("compact", 2, "gru", False), ("pallas", 2, "gru", False)]


@pytest.mark.parametrize("backend,L,kind,col", _ENGINE_CASES)
def test_stacked_rtrl_matches_reference_and_oracles(backend, L, kind, col):
    jcfg, cfg, params, masks, xs, ys = _setup(kind, L)
    jl, jg, js = JST.stacked_rtrl_loss_and_grads(
        jcfg, _jtree(params), jnp.asarray(xs), jnp.asarray(ys),
        _jtree(masks), backend=backend, interpret=backend == "pallas",
        col_compact=col)
    pm, tp = _pmasks(masks), params_from_numpy(params, "cpu")
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    tl, tg, ts = ST.stacked_rtrl_loss_and_grads(
        cfg, tp, x, y, pm, backend=backend, col_compact=col)
    assert float(tl) == pytest.approx(float(jl), rel=REL)
    _assert_trees_close(_survivors(tg, pm),
                        JST.apply_stacked_masks(jg, _jtree(masks)))
    assert set(ts) == set(js)
    for k in ("alpha", "beta", "alpha_layers", "beta_layers", "beta_prev",
              "m_row_density"):
        np.testing.assert_allclose(to_numpy(ts[k]), np.asarray(js[k]),
                                   rtol=1e-6, err_msg=k)
    if "overflow" in js:
        assert int(ts["overflow"].max()) == int(js["overflow"].max()) == 0
    # the port's own oracles, on surviving parameters
    bl, bg, _ = B.stacked_bptt_loss_and_grads(cfg, tp, x, y)
    assert float(tl) == pytest.approx(float(bl), rel=REL)
    _assert_trees_close(_survivors(tg, pm), to_numpy(_survivors(bg, pm)))
    if backend == "compact_fused":
        ol, og, _ = R.stacked_rtrl_loss_and_grads(cfg, tp, x, y)
        assert float(tl) == pytest.approx(float(ol), rel=REL)
        _assert_trees_close(_survivors(tg, pm), to_numpy(_survivors(og, pm)))


@pytest.mark.parametrize("backend", ["compact", "pallas"])
def test_block_engine_at_one_layer_matches_reference(backend):
    """delegate_single_layer=False runs the block engine at L = 1; it
    agrees with the JAX block engine and with the delegated path."""
    jcfg, cfg, params, masks, xs, ys = _setup("gru", 1)
    jl, jg, _ = JST.stacked_rtrl_loss_and_grads(
        jcfg, _jtree(params), jnp.asarray(xs), jnp.asarray(ys),
        _jtree(masks), backend=backend, interpret=True,
        delegate_single_layer=False)
    args = (cfg, params_from_numpy(params, "cpu"), torch.from_numpy(xs),
            torch.from_numpy(ys), _pmasks(masks))
    tl, tg, ts = ST.stacked_rtrl_loss_and_grads(
        *args, backend=backend, delegate_single_layer=False)
    dl, dg, _ = ST.stacked_rtrl_loss_and_grads(*args, backend=backend)
    assert float(tl) == pytest.approx(float(jl), rel=REL)
    _assert_trees_close(tg, jg)
    assert float(dl) == pytest.approx(float(tl), rel=REL)
    _assert_trees_close(dg, to_numpy(tg))
    assert tuple(ts["beta_prev"].shape) == (xs.shape[0], 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compact_fused_equals_compact_at_two_layers(dtype):
    """Inside the port: the fused engine (one K1 call a layer, cross term
    folded into M-bar) against the compact engine, f32 within 1e-5, a bf16
    carry within one bf16 step; the same active rows."""
    _, cfg, params, masks, xs, ys = _setup("gru", 2, T=6)
    args = (cfg, params_from_numpy(params, "cpu"), torch.from_numpy(xs),
            torch.from_numpy(ys), _pmasks(masks))
    fl, fg, fs = ST.stacked_rtrl_loss_and_grads(
        *args, backend="compact_fused", influence_dtype=dtype)
    cl, cg, cs = ST.stacked_rtrl_loss_and_grads(
        *args, backend="compact", influence_dtype=dtype)
    rel = REL if dtype == "float32" else 2.0 ** -7
    assert float(fl) == pytest.approx(float(cl), rel=REL)
    _assert_trees_close(fg, to_numpy(cg), rel=rel)
    np.testing.assert_array_equal(to_numpy(fs["m_row_density"]),
                                  to_numpy(cs["m_row_density"]))


@pytest.mark.parametrize("backend,col", [("dense", None), ("pallas", None),
                                         ("pallas", False),
                                         ("compact", False),
                                         ("compact", None),
                                         ("compact_fused", None)])
def test_stream_path_equals_whole_sequence_bitwise(backend, col):
    """update_every = T: the online stream path reproduces the
    whole-sequence path bit for bit at L = 2 (after the JAX package's
    test_online_equals_offline_stacked)."""
    _, cfg, params, masks, xs, ys = _setup("gru", 2)
    pm, tp = _pmasks(masks), params_from_numpy(params, "cpu")
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    l_ref, g_ref, _ = ST.stacked_rtrl_loss_and_grads(
        cfg, tp, x, y, pm, backend=backend, col_compact=col)
    learner = make_learner(LearnerSpec(engine="stacked", cfg=cfg,
                                       backend=backend, col_compact=col))
    carry = learner.init(tp, pm, (x[0], y), t_total=x.shape[0])
    carry, loss, grads, _ = ON.stream_grads(
        learner, carry, x, y.expand(x.shape[0], -1))
    assert torch.equal(loss, l_ref)
    for (pa, a), (pb, b) in zip(tree_flatten_with_path(grads),
                                tree_flatten_with_path(g_ref)):
        assert pa == pb and torch.equal(a, b), pa


@pytest.mark.parametrize("backend,col", [("dense", None), ("pallas", None),
                                         ("compact", None),
                                         ("compact", False)])
def test_dead_rows_and_upper_layer_columns_stay_zero(backend, col):
    """The sparsity invariant at depth (after the JAX package's
    test_stacked_zero_hp_rows_kill_all_influence_blocks): rows of every
    layer's influence vanish where H'(v^l_t) == 0, and the columns of
    layers j > l stay exactly zero: on the full-width carry beyond layer
    l's block, on the shared compact axis where the owning layer is
    above l."""
    _, cfg, params, masks, xs, ys = _setup("gru", 3, sparsity=0.5, T=6)
    learner = make_learner(LearnerSpec(engine="stacked", cfg=cfg,
                                       backend=backend, col_compact=col))
    pm = _pmasks(masks)
    carry = learner.init(params_from_numpy(params, "cpu"), pm,
                         (torch.from_numpy(xs[0]), torch.from_numpy(ys)), 6.0)
    sl, saw_dead = learner.slayout, False
    ws = params_from_numpy(params, "cpu")["layers"]
    for t in range(xs.shape[0]):
        a_prev = carry["a"]
        carry, _ = learner.step(carry, torch.from_numpy(xs[t]),
                                torch.from_numpy(ys))
        inp = torch.from_numpy(xs[t])
        for l in range(3):
            lcfg = cfg.layer_cfg(l)
            hp = C.pseudo_derivative(C.pre_activation(lcfg, ws[l], a_prev[l],
                                                      inp), lcfg)
            inp = carry["a"][l]
            if "M" in carry:
                M = carry["M"][l]
                dead = hp == 0                           # [B, n_l]
            else:
                M = carry["vals"][l]
                idx = carry["idx"][l]
                dead = idx < 0                           # [B, K_l]
                live_units = torch.zeros_like(hp, dtype=torch.bool)
                for b in range(hp.shape[0]):
                    live_units[b, idx[b][idx[b] >= 0].long()] = True
                assert torch.equal(live_units, hp != 0), (t, l)
            saw_dead = saw_dead or bool(dead.any())
            assert bool((M[dead] == 0).all()), (t, l)
            if learner._cl is not None:
                upper = learner._cl.layer > l
                assert bool((M[:, :, upper] == 0).all()), (t, l)
            else:
                start = sl.offsets[l] + sl.layers[l].P
                assert bool((M[:, :, start:] == 0).all()), (t, l)
    assert saw_dead


def test_stacked_learner_refusals():
    cfg = C.stacked_config(C.EGRUConfig(), 2)
    for backend in ("dense", "pallas"):
        with pytest.raises(ValueError, match="compact carry"):
            make_learner(LearnerSpec(engine="stacked", cfg=cfg,
                                     backend=backend,
                                     influence_dtype="bfloat16"))
    with pytest.raises(ValueError, match="rewirable=True"):
        make_learner(LearnerSpec(engine="stacked", cfg=cfg,
                                 backend="compact_fused", rewirable=True))
    with pytest.raises(ValueError, match="backend"):
        make_learner(LearnerSpec(engine="stacked", cfg=cfg, backend="nope"))
    fused = make_learner(LearnerSpec(engine="stacked", cfg=cfg,
                                     backend="compact_fused",
                                     col_compact=False))
    p = C.init_stacked_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with pytest.raises(ValueError, match="column-compact"):
        fused.init(p, None, (torch.zeros(2, 2), torch.zeros(2)), 8.0)
    # a plain EGRUConfig with layers=2 builds the same engine
    lr = make_learner(LearnerSpec(engine="stacked", cfg=C.EGRUConfig(),
                                  layers=2, backend="compact"))
    assert lr.cfg == cfg
