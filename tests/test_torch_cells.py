"""The port's EGRU cell, configs and spiral data held against the JAX
package on the same numpy inputs.

Tolerance: float32 values agree to 1e-5 relative and absolute (the same
formulas, evaluated in another order by another library); the Heaviside
outputs and the pure-numpy data agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cells import egru as JE
from repro.configs import egru_spiral as JSPIRAL
from repro.core import cells as JC
from repro.data.spiral import spiral_dataset as j_spiral_dataset
from repro_torch.cells import resolve_cell
from repro_torch.cells import egru as E
from repro_torch.cells.egru import EGRUCell
from repro_torch.configs import egru_spiral as SPIRAL
from repro_torch.core import cells as C
from repro_torch.data.spiral import spiral_dataset
from repro_torch.weights import params_from_numpy, to_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _params_np(kind, n, n_in, n_out, seed):
    jcfg = JC.EGRUConfig(n_hidden=n, n_in=n_in, n_out=n_out, kind=kind)
    p = JC.init_params(jcfg, jax.random.key(seed))
    return jax.tree.map(np.asarray, p)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("kind", ["gru", "rnn"])
@pytest.mark.parametrize("dense", [False, True])
def test_cell_partials_match_reference(kind, dense):
    n, n_in, B = 12, 3, 5
    jcfg = JC.EGRUConfig(n_hidden=n, n_in=n_in, n_out=2, kind=kind,
                         dense=dense)
    cfg = C.EGRUConfig(n_hidden=n, n_in=n_in, n_out=2, kind=kind, dense=dense)
    rng = np.random.default_rng(0)
    pnp = _params_np(kind, n, n_in, 2, seed=1)
    w_np = {k: v for k, v in pnp.items() if k != "out"}
    # a previous activity with events and zeros, plus a dense-valued one
    a_prev = (rng.random((B, n)) > 0.5).astype(np.float32)
    if dense:
        a_prev = np.tanh(rng.normal(size=(B, n))).astype(np.float32)
    x = rng.normal(size=(B, n_in)).astype(np.float32)
    ja, jhp, jJ, jm = JE.cell_partials(
        jcfg, jax.tree.map(jnp.asarray, w_np), jnp.asarray(a_prev),
        jnp.asarray(x))
    a, hp, J, m = E.cell_partials(cfg, params_from_numpy(w_np, "cpu"),
                                  torch.from_numpy(a_prev),
                                  torch.from_numpy(x))
    if dense:
        np.testing.assert_allclose(_np(a), _np(ja), **TOL)
    else:
        np.testing.assert_array_equal(_np(a), _np(ja))
    np.testing.assert_allclose(_np(hp), _np(jhp), **TOL)
    np.testing.assert_allclose(_np(J), _np(jJ), **TOL)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(_np(m[k]), _np(jm[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("kind", ["gru", "rnn"])
def test_step_readout_xent_match_reference(kind):
    n, n_in, B = 10, 2, 6
    jcfg = JC.EGRUConfig(n_hidden=n, n_in=n_in, n_out=3, kind=kind)
    cfg = C.EGRUConfig(n_hidden=n, n_in=n_in, n_out=3, kind=kind)
    rng = np.random.default_rng(2)
    pnp = _params_np(kind, n, n_in, 3, seed=3)
    a_prev = (rng.random((B, n)) > 0.4).astype(np.float32)
    x = rng.normal(size=(B, n_in)).astype(np.float32)
    y = rng.integers(0, 3, B).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, pnp)
    tp = params_from_numpy(pnp, "cpu")
    ja, jst = JC.step(jcfg, JC.rec_param_tree(jp), jnp.asarray(a_prev),
                      jnp.asarray(x))
    a, st = C.step(cfg, C.rec_param_tree(tp), torch.from_numpy(a_prev),
                   torch.from_numpy(x))
    np.testing.assert_array_equal(_np(a), _np(ja))
    for k in ("v", "hp", "alpha", "beta"):
        np.testing.assert_allclose(_np(st[k]), _np(jst[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(_np(C.readout(tp, a)),
                               _np(JC.readout(jp, ja)), **TOL)
    np.testing.assert_allclose(
        float(C.xent(C.readout(tp, a), torch.from_numpy(y))),
        float(JC.xent(JC.readout(jp, ja), jnp.asarray(y))), **TOL)


def test_pseudo_derivative_and_strict_heaviside():
    cfg = C.EGRUConfig()
    v = np.array([-1.0, -0.6, -0.3, 0.0, 1e-7, 0.3, 0.6, 1.0], np.float32)
    np.testing.assert_allclose(
        _np(C.pseudo_derivative(torch.from_numpy(v), cfg)),
        _np(JC.pseudo_derivative(jnp.asarray(v), JC.EGRUConfig())), **TOL)
    h = _np(C.heaviside(torch.from_numpy(v)))
    np.testing.assert_array_equal(h, _np(JC.heaviside(jnp.asarray(v))))
    assert h[3] == 0.0 and h[4] == 1.0          # strict v > 0


@pytest.mark.parametrize("kind", ["gru", "rnn"])
def test_init_params_tree_matches_reference_layout(kind):
    cfg = C.EGRUConfig(n_hidden=8, n_in=3, n_out=2, kind=kind)
    p = C.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = _params_np(kind, 8, 3, 2, seed=0)
    shapes = jax.tree.map(lambda a: a.shape, jp)
    assert jax.tree.map(lambda a: a.shape, to_numpy(p)) == shapes
    again = C.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(jax.tree.leaves(to_numpy(p)),
                    jax.tree.leaves(to_numpy(again))):
        np.testing.assert_array_equal(a, b)          # seeded: reproducible
    assert (to_numpy(p)["theta"] >= 0).all()


def test_stacked_params_and_config_match_reference():
    scfg = SPIRAL.stacked(1)
    jscfg = JSPIRAL.stacked(1)
    for f in ("layer_sizes", "n_in", "n_out", "kind", "dense", "gamma", "eps",
              "seq_len", "batch_size", "iterations", "lr"):
        assert getattr(scfg, f) == getattr(jscfg, f), f
    assert scfg.n_rec_params == jscfg.n_rec_params
    assert SPIRAL.CONFIG.m == JSPIRAL.CONFIG.m
    p = C.init_stacked_params(scfg, torch.Generator().manual_seed(0),
                              device="cpu")
    jp = JC.init_stacked_params(jscfg, jax.random.key(0))
    assert jax.tree.map(lambda a: a.shape, to_numpy(p)) == \
        jax.tree.map(lambda a: a.shape, jax.tree.map(np.asarray, jp))
    two = C.stacked_config(SPIRAL.CONFIG, 2, (16, 8))
    assert two.layer_cfg(1).n_in == 16 and two.layer_cfg(1).n_hidden == 8


@pytest.mark.parametrize("seed,T,n", [(0, 17, 10_000), (3, 9, 257)])
def test_spiral_dataset_array_equal(seed, T, n):
    xs, ys = spiral_dataset(n_samples=n, T=T, seed=seed)
    jxs, jys = j_spiral_dataset(n_samples=n, T=T, seed=seed)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)
    assert xs.dtype == jxs.dtype and ys.dtype == jys.dtype


def test_resolve_cell_egru_only():
    """The dispatch by config type: EGRU, rgLRU, SNN and the toy diagonal
    cell (the whole zoo since the cell zoo was ported); an unknown type
    raises ValueError, as in the reference."""
    from repro_torch.cells import DiagCell, RGLRUCell, SNNCell
    from repro_torch.cells.rglru import RGLRUCellConfig
    from repro_torch.cells.snn import SNNConfig
    from repro_torch.core.diag_rtrl import DiagCellConfig
    cell = resolve_cell(C.EGRUConfig(n_hidden=4))
    assert isinstance(cell, EGRUCell) and cell.jac_kind == "dense"
    a = cell.init_state(3, device="cpu")
    assert a.shape == (3, 4) and not cell.activity_mask(a).any()
    for cfg, kind, jac in ((RGLRUCellConfig(n=4), RGLRUCell, "diagonal"),
                           (SNNConfig(n=4), SNNCell, "dense"),
                           (DiagCellConfig(n=4), DiagCell, "diagonal")):
        cell = resolve_cell(cfg)
        assert type(cell) is kind and cell.jac_kind == jac
        assert cell.cfg is cfg
    with pytest.raises(ValueError, match="no cell registered"):
        resolve_cell(object())
