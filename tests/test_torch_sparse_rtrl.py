"""The port's sparse-RTRL core (masks, layouts, column maps, the compact
steps) held against the JAX package on the same numpy inputs.

Tolerance: float32 values agree to 1e-5 relative and absolute; integer
results (active sets, counts, layouts) agree exactly.  Steps start from an
identical carry: the Heaviside gate makes long trajectories chaotic under
round-off, so single steps are what is pinned here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cells as JC, sparse_rtrl as JSP, stacked_rtrl as JST
from repro.kernels import compact as JCK
from repro_torch.core import cells as C, sparse_rtrl as SP, stacked_rtrl as ST
from repro_torch.kernels import compact as CK
from repro_torch.weights import masks_from_numpy, params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.cpu().numpy()
    return np.asarray(x)


def _tree_np(t):
    return jax.tree.map(np.asarray, t)


def _setup(kind, sparsity, n=16, n_in=3, B=4, seed=0):
    """(jcfg, cfg, params_np, masks_np) with the params masked."""
    jcfg = JC.EGRUConfig(n_hidden=n, n_in=n_in, n_out=2, kind=kind)
    cfg = C.EGRUConfig(n_hidden=n, n_in=n_in, n_out=2, kind=kind)
    params = JC.init_params(jcfg, jax.random.key(seed))
    masks = None
    if sparsity is not None:
        masks = JSP.make_masks(jcfg, jax.random.key(seed + 7), sparsity)
        params = JSP.apply_masks(params, masks)
        masks = jax.tree.map(np.asarray, masks)
    return jcfg, cfg, _tree_np(params), masks


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _port_masks(masks_np):
    return None if masks_np is None else masks_from_numpy(masks_np, "cpu")


# ---------------------------------------------------------------------------
# masks and layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gru", "rnn"])
def test_masks_apply_and_density_match_reference(kind):
    jcfg, cfg, params, masks = _setup(kind, 0.8)
    tp = SP.apply_masks(params_from_numpy(params, "cpu"), _port_masks(masks))
    jp = JSP.apply_masks(_jtree(params), _jtree(masks))
    for a, b in zip(jax.tree.leaves(_tree_np(jp)),
                    jax.tree.leaves(jax.tree.map(_np, tp))):
        np.testing.assert_array_equal(a, b)
    assert SP.omega_tilde(_port_masks(masks)) == pytest.approx(
        float(JSP.omega_tilde(_jtree(masks))), abs=1e-7)
    # the port's own draw: the requested density, the reference's structure
    own = SP.make_masks(cfg, torch.Generator().manual_seed(1), 0.8,
                        device="cpu")
    assert jax.tree.map(lambda a: a.shape, jax.tree.map(_np, own)) == \
        jax.tree.map(lambda a: a.shape, masks)
    assert 0.1 < SP.omega_tilde(own) < 0.3
    blocky = SP.make_masks(cfg, torch.Generator().manual_seed(1), 0.5,
                           device="cpu", block=4)
    R = _np(blocky[SP.mask_gates(kind)[0]]["R"])
    assert (R.reshape(4, 4, 4, 4) == R[::4, ::4][:, None, :, None]).all()


@pytest.mark.parametrize("kind,sparsity", [("gru", 0.8), ("gru", 0.5),
                                           ("rnn", 0.7), ("gru", None)])
def test_layouts_and_col_layout_match_reference(kind, sparsity):
    jcfg, cfg, _, masks = _setup(kind, sparsity)
    jl, layout = JSP.flat_layout(jcfg), SP.flat_layout(cfg)
    for f in ("kind", "n", "n_in", "gates", "m", "P", "P_pad"):
        assert getattr(layout, f) == getattr(jl, f), f
    np.testing.assert_array_equal(
        _np(SP.flat_col_mask(layout, _port_masks(masks), device="cpu")),
        np.asarray(JSP.flat_col_mask(jl, None if masks is None
                                     else _jtree(masks))))
    jcl = JSP.col_layout(jl, masks)
    cl = SP.col_layout(layout, _port_masks(masks), device="cpu")
    assert (cl.Pc, cl.Pc_pad, cl.P_pad) == (jcl.Pc, jcl.Pc_pad, jcl.P_pad)
    for f in ("src", "layer", "gate", "q", "j", "live"):
        np.testing.assert_array_equal(_np(getattr(cl, f)),
                                      np.asarray(getattr(jcl, f)), err_msg=f)
    # the column maps' round trip matches, and kills exactly the dead columns
    x = np.random.default_rng(0).normal(size=(2, layout.P_pad)).astype(
        np.float32)
    xc = SP.flat_to_cols(cl, torch.from_numpy(x))
    np.testing.assert_array_equal(_np(xc), np.asarray(
        JSP.flat_to_cols(jcl, jnp.asarray(x))))
    np.testing.assert_array_equal(_np(SP.cols_to_flat(cl, xc)), np.asarray(
        JSP.cols_to_flat(jcl, JSP.flat_to_cols(jcl, jnp.asarray(x)))))


def test_stacked_one_layer_helpers_match_reference():
    jscfg = JC.stacked_config(JC.EGRUConfig(), 1)
    scfg = C.stacked_config(C.EGRUConfig(), 1)
    jmasks = JST.make_stacked_masks(jscfg, jax.random.key(3), 0.8)
    masks = [masks_from_numpy(jax.tree.map(np.asarray, m), "cpu")
             for m in jmasks]
    jsl, sl = JST.stacked_layout(jscfg), ST.stacked_layout(scfg)
    assert (sl.offsets, sl.P_total, sl.P_pad) == \
        (jsl.offsets, jsl.P_total, jsl.P_pad)
    np.testing.assert_array_equal(
        _np(ST.stacked_col_mask(sl, masks, device="cpu")),
        np.asarray(JST.stacked_col_mask(jsl, jmasks)))
    assert ST.stacked_omega_tilde(masks) == pytest.approx(
        float(JST.stacked_omega_tilde(jmasks)), abs=1e-7)
    params = JC.init_stacked_params(jscfg, jax.random.key(4))
    jp = JST.apply_stacked_masks(params, jmasks)
    tp = ST.apply_stacked_masks(params_from_numpy(_tree_np(params), "cpu"),
                                masks)
    for a, b in zip(jax.tree.leaves(_tree_np(jp)),
                    jax.tree.leaves(jax.tree.map(_np, tp))):
        np.testing.assert_array_equal(a, b)
    own = ST.make_stacked_masks(scfg, torch.Generator().manual_seed(0), 0.8,
                                device="cpu")
    assert isinstance(own, list) and "out" not in own[0]


def test_capacity_K_matches_reference():
    for n in (8, 12, 16, 40, 256):
        for cap in (0.1, 0.34, 0.5, 0.9, 1.0):
            assert SP.capacity_K(n, cap) == JSP.capacity_K(n, cap)


# ---------------------------------------------------------------------------
# compact kernels' torch ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [8, 16, 24])
def test_compact_rows_gather_and_grads_match_reference(K):
    rng = np.random.default_rng(K)
    B, n = 5, 16
    mask = rng.random((B, n)) > 0.5
    mask[0] = True
    idx, cnt = CK.compact_rows(torch.from_numpy(mask), K)
    jidx, jcnt = JCK.compact_rows(jnp.asarray(mask), K)
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    np.testing.assert_array_equal(_np(cnt), np.asarray(jcnt))
    J = rng.normal(size=(B, n, n)).astype(np.float32)
    prev, _ = JCK.compact_rows(jnp.asarray(rng.random((B, n)) > 0.3), K)
    np.testing.assert_array_equal(
        _np(CK.gather_j_tiles(torch.from_numpy(J), idx,
                              torch.from_numpy(np.array(prev)))),
        np.asarray(JCK.gather_j_tiles(jnp.asarray(J), jidx, prev)))
    R = rng.normal(size=(n, n)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(CK.gather_j_tiles(None, idx, torch.from_numpy(np.array(prev)),
                              R=torch.from_numpy(R))),
        np.asarray(JCK.gather_j_tiles(None, jidx, prev, R=jnp.asarray(R))))
    vals = rng.normal(size=(B, K, 128)).astype(np.float32)
    cbar = rng.normal(size=(B, n)).astype(np.float32)
    np.testing.assert_allclose(
        _np(CK.compact_grads(torch.from_numpy(vals), idx,
                             torch.from_numpy(cbar))),
        np.asarray(JCK.compact_grads(jnp.asarray(vals), jidx,
                                     jnp.asarray(cbar))), **TOL)
    with pytest.raises(ValueError, match="sentinel"):
        CK.check_idx(torch.tensor([[0, -2]]), n)


# ---------------------------------------------------------------------------
# one step from an identical carry
# ---------------------------------------------------------------------------

def _carry_after(jcfg, params, masks, xs, K):
    """A live carry (a, vals, idx) from JAX compact steps over xs."""
    jl = JSP.flat_layout(jcfg)
    jcl = JSP.col_layout(jl, masks)
    w = JC.rec_param_tree(_jtree(params))
    B = xs.shape[1]
    a = jnp.zeros((B, jcfg.n_hidden))
    vals = jnp.zeros((B, K, jcl.Pc_pad))
    idx = jnp.full((B, K), -1, jnp.int32)
    for x in xs:
        a, _, vals, idx, _, _ = JSP.flat_compact_step(
            jcfg, w, jl, a, vals, idx, jnp.asarray(x), None, cl=jcl)
    return jl, jcl, np.array(a), np.array(vals), np.array(idx)


@pytest.mark.parametrize("kind,sparsity", [("gru", 0.8), ("rnn", 0.6),
                                           ("gru", None)])
def test_compact_and_fused_step_from_identical_carry(kind, sparsity):
    jcfg, cfg, params, masks = _setup(kind, sparsity, seed=1)
    rng = np.random.default_rng(5)
    xs = (rng.normal(size=(4, 4, jcfg.n_in))
          * np.linspace(0.3, 2.0, 4)[None, :, None]).astype(np.float32)
    K = JSP.capacity_K(jcfg.n_hidden, 1.0)
    jl, jcl, a, vals, idx = _carry_after(jcfg, params, masks, xs[:3], K)
    assert (idx >= 0).sum() > 0                 # a live carry
    x = xs[3]
    w = JC.rec_param_tree(_jtree(params))
    ja = (jnp.asarray(a), jnp.asarray(vals), jnp.asarray(idx),
          jnp.asarray(x))
    want_c = JSP.flat_compact_step(jcfg, w, jl, ja[0], ja[1], ja[2], ja[3],
                                   None, cl=jcl)
    want_k = JSP.flat_compact_fused_step(jcfg, w, jl, *ja, cl=jcl,
                                         use_kernel=True, interpret=True)
    want_x = JSP.flat_compact_fused_step(jcfg, w, jl, *ja, cl=jcl)
    layout = SP.flat_layout(cfg)
    cl = SP.col_layout(layout, _port_masks(masks), device="cpu")
    tw = C.rec_param_tree(params_from_numpy(params, "cpu"))
    ta = [torch.from_numpy(t) for t in (a, vals, idx, x)]
    got_c = SP.flat_compact_step(cfg, tw, layout, *ta, cl=cl)
    got_f = SP.flat_compact_fused_step(cfg, tw, layout, *ta, cl=cl)
    for got in (got_c, got_f):
        for want in (want_c, want_k, want_x):
            a1, hp1, v1, i1, c1, o1 = got
            a2, hp2, v2, i2, c2, o2 = want
            np.testing.assert_array_equal(_np(a1), np.asarray(a2))
            np.testing.assert_allclose(_np(hp1), np.asarray(hp2), **TOL)
            np.testing.assert_array_equal(_np(i1), np.asarray(i2))
            np.testing.assert_array_equal(_np(c1), np.asarray(c2))
            np.testing.assert_array_equal(_np(o1), np.asarray(o2))
            np.testing.assert_allclose(_np(v1), np.asarray(v2), **TOL)


def test_full_width_mode_equals_column_compact():
    """The full-width carry (no column map; M-bar rows on the flat axis,
    dead columns zeroed by col_mask, as in the JAX package) gives the same
    influence, column for column, as the column-compact carry."""
    jcfg, cfg, params, masks = _setup("gru", 0.7, seed=2)
    layout = SP.flat_layout(cfg)
    pm = _port_masks(masks)
    cl = SP.col_layout(layout, pm, device="cpu")
    colm = SP.flat_col_mask(layout, pm, device="cpu")
    tw = C.rec_param_tree(params_from_numpy(params, "cpu"))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, jcfg.n_in)).astype(np.float32))
    a = torch.zeros(4, 16)
    K = SP.capacity_K(16, 1.0)
    idx = torch.full((4, K), -1, dtype=torch.int32)
    vc, vf = torch.zeros(4, K, cl.Pc_pad), torch.zeros(4, K, layout.P_pad)
    for _ in range(3):
        a2, _, vc, idx2, _, _ = SP.flat_compact_step(cfg, tw, layout, a, vc,
                                                     idx, x, cl=cl)
        _, _, vf, _, _, _ = SP.flat_compact_step(cfg, tw, layout, a, vf,
                                                 idx, x, col_mask=colm)
        a, idx = a2, idx2
    np.testing.assert_allclose(_np(SP.cols_to_flat(cl, vc)), _np(vf), **TOL)


@pytest.mark.parametrize("kind", ["gru", "rnn"])
def test_mbar_rows_and_unflatten_match_reference(kind):
    jcfg, cfg, params, masks = _setup(kind, 0.6, seed=3)
    rng = np.random.default_rng(4)
    a = (rng.random((3, 16)) > 0.5).astype(np.float32)
    x = rng.normal(size=(3, jcfg.n_in)).astype(np.float32)
    jl, layout = JSP.flat_layout(jcfg), SP.flat_layout(cfg)
    jcl = JSP.col_layout(jl, masks)
    cl = SP.col_layout(layout, _port_masks(masks), device="cpu")
    _, _, _, jm = JSP.cell_partials(jcfg, JC.rec_param_tree(_jtree(params)),
                                    jnp.asarray(a), jnp.asarray(x))
    from repro_torch.cells.egru import cell_partials
    _, _, _, m = cell_partials(cfg, C.rec_param_tree(
        params_from_numpy(params, "cpu")), torch.from_numpy(a),
        torch.from_numpy(x))
    safe = rng.integers(0, 16, (3, 8)).astype(np.int32)
    np.testing.assert_allclose(
        _np(SP.flat_mbar_rows_cols(cfg, layout, cl, m, torch.from_numpy(safe))),
        np.asarray(JSP.flat_mbar_rows_cols(jcfg, jl, jcl, jm,
                                           jnp.asarray(safe))), **TOL)
    gw = rng.normal(size=(layout.P_pad,)).astype(np.float32)
    got = SP.unflatten_flat_grads(cfg, layout, torch.from_numpy(gw))
    want = JSP.unflatten_flat_grads(jcfg, jl, jnp.asarray(gw))
    for g, w in zip(jax.tree.leaves(jax.tree.map(_np, got)),
                    jax.tree.leaves(_tree_np(want))):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the dense flat carry (backend "pallas") and the per-gate backend "dense"
# ---------------------------------------------------------------------------

def _partials(jcfg, cfg, params, a, x):
    """The same step's partials from both packages."""
    from repro_torch.cells.egru import cell_partials
    jp = JSP.cell_partials(jcfg, JC.rec_param_tree(_jtree(params)),
                           jnp.asarray(a), jnp.asarray(x))
    tp = cell_partials(cfg, C.rec_param_tree(params_from_numpy(params, "cpu")),
                       torch.from_numpy(a), torch.from_numpy(x))
    return jp, tp


@pytest.mark.parametrize("kind", ["gru", "rnn"])
def test_flat_jmask_and_mbar_match_reference(kind):
    jcfg, cfg, params, masks = _setup(kind, 0.7, seed=4)
    pm = _port_masks(masks)
    np.testing.assert_array_equal(_np(SP.flat_jmask(cfg, pm)),
                                  np.asarray(JSP.flat_jmask(jcfg, _jtree(masks))))
    assert SP.flat_jmask(cfg, None) is None
    rng = np.random.default_rng(6)
    a = (rng.random((3, 16)) > 0.5).astype(np.float32)
    x = rng.normal(size=(3, jcfg.n_in)).astype(np.float32)
    (_, _, _, jm), (_, _, _, m) = _partials(jcfg, cfg, params, a, x)
    jl, layout = JSP.flat_layout(jcfg), SP.flat_layout(cfg)
    colm = SP.flat_col_mask(layout, pm, device="cpu")
    for cm, jcm in ((None, None), (colm, JSP.flat_col_mask(jl, _jtree(masks)))):
        np.testing.assert_allclose(
            _np(SP.flat_mbar(cfg, layout, m, cm)),
            np.asarray(JSP.flat_mbar(jcfg, jl, jm, jcm)), **TOL)
    jcl = JSP.col_layout(jl, masks)
    cl = SP.col_layout(layout, pm, device="cpu")
    np.testing.assert_allclose(_np(SP.flat_mbar_cols(cfg, layout, cl, m)),
                               np.asarray(JSP.flat_mbar_cols(jcfg, jl, jcl, jm)),
                               **TOL)
    M0 = SP.init_influence_flat(layout, 3, device="cpu")
    assert M0.shape == JSP.init_influence_flat(jl, 3).shape and not M0.any()


@pytest.mark.parametrize("kind,sparsity", [("gru", 0.6), ("rnn", 0.6),
                                           ("gru", None)])
def test_per_gate_influence_update_and_grads_match_reference(kind, sparsity):
    jcfg, cfg, params, masks = _setup(kind, sparsity, seed=5)
    pm = None if masks is None else _port_masks(masks)
    jmk = None if masks is None else _jtree(masks)
    rng = np.random.default_rng(7)
    B = 4
    jM, M = JSP.init_influence(jcfg, B), SP.init_influence(cfg, B, device="cpu")
    assert jax.tree.map(np.shape, jM) == {k: tuple(v.shape) for k, v in M.items()}
    a = np.zeros((B, 16), np.float32)
    for t in range(3):
        x = (rng.normal(size=(B, jcfg.n_in)) * 1.5).astype(np.float32)
        (ja, jhp, jJ, jm), (ta, hp, J, m) = _partials(jcfg, cfg, params, a, x)
        # identical carries into each step, so the comparison pins one step
        M = {k: torch.from_numpy(np.array(v)) for k, v in jM.items()}
        jM = JSP.influence_update(jcfg, jM, jhp, jJ, jm, jmk)
        got = SP.influence_update(cfg, M, hp, J, m, pm)
        for k in jM:
            np.testing.assert_allclose(_np(got[k]), np.asarray(jM[k]), **TOL,
                                       err_msg=f"step {t} gate {k}")
        a = np.array(ja)
    cbar = rng.normal(size=(B, 16)).astype(np.float32)
    want = JSP.influence_grads(jcfg, jM, jnp.asarray(cbar))
    gotg = SP.influence_grads(cfg, got, torch.from_numpy(cbar))
    for g, w in zip(jax.tree.leaves(jax.tree.map(_np, gotg)),
                    jax.tree.leaves(_tree_np(want))):
        np.testing.assert_allclose(g, w, **TOL)
    assert float(SP._row_density(got)) == pytest.approx(
        float(JSP._row_density(jM)), abs=1e-7)
    assert float(SP.influence_col_density(got)) == pytest.approx(
        float(JSP.influence_col_density(jM)), abs=1e-7)


def _sequence(jcfg, B=4, T=6, seed=9):
    rng = np.random.default_rng(seed)
    xs = (rng.normal(size=(T, B, jcfg.n_in))
          * np.linspace(0.5, 2.0, B)[None, :, None]).astype(np.float32)
    return xs, rng.integers(0, 2, B).astype(np.int32)


def _assert_grads_close(got, want):
    for g, w in zip(jax.tree.leaves(jax.tree.map(_np, got)),
                    jax.tree.leaves(_tree_np(want))):
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("backend,sparsity", [
    ("dense", 0.7), ("pallas", 0.7), ("compact", 0.7), ("compact_fused", 0.7),
    ("dense", None), ("pallas", None)])
def test_sparse_rtrl_loss_and_grads_matches_reference(backend, sparsity):
    jcfg, cfg, params, masks = _setup("gru", sparsity, seed=6)
    xs, ys = _sequence(jcfg)
    jl, jg, js = JSP.sparse_rtrl_loss_and_grads(
        jcfg, _jtree(params), jnp.asarray(xs), jnp.asarray(ys),
        None if masks is None else _jtree(masks), backend=backend)
    tl, tg, ts = SP.sparse_rtrl_loss_and_grads(
        cfg, params_from_numpy(params, "cpu"), torch.from_numpy(xs),
        torch.from_numpy(ys), _port_masks(masks), backend=backend)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    _assert_grads_close(tg, jg)
    assert set(ts) == set(js)
    for k in ts:
        np.testing.assert_allclose(_np(ts[k]), np.asarray(js[k]), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("kind,dense", [("gru", False), ("rnn", False),
                                        ("gru", True)])
def test_bptt_oracle_matches_reference_and_port_rtrl(kind, dense):
    from repro.core import bptt as JB
    from repro_torch.core import bptt as TB
    jcfg, cfg, params, masks = _setup(kind, 0.7, seed=7)
    jcfg, cfg = jcfg.replace(dense=dense), cfg.replace(dense=dense)
    xs, ys = _sequence(jcfg, seed=10)
    jl, jg, js = JB.bptt_loss_and_grads(jcfg, _jtree(params), jnp.asarray(xs),
                                        jnp.asarray(ys))
    tl, tg, ts = TB.bptt_loss_and_grads(cfg, params_from_numpy(params, "cpu"),
                                        torch.from_numpy(xs),
                                        torch.from_numpy(ys))
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    _assert_grads_close(tg, jg)
    np.testing.assert_allclose(_np(ts["alpha"]), np.asarray(js["alpha"]),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(ts["logits_mean"]),
                               np.asarray(js["logits_mean"]), **TOL)
    # inside the port: exact RTRL equals BPTT on every surviving parameter
    rl, rg, _ = SP.sparse_rtrl_loss_and_grads(
        cfg, params_from_numpy(params, "cpu"), torch.from_numpy(xs),
        torch.from_numpy(ys), _port_masks(masks), backend="dense")
    assert float(rl) == pytest.approx(float(tl), rel=1e-5)
    _assert_grads_close(SP.apply_masks(rg, _port_masks(masks)),
                        jax.tree.map(_np, SP.apply_masks(
                            tg, _port_masks(masks))))
