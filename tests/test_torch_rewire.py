"""The port's dynamic sparsity (`repro_torch.sparsity`, the learners'
`rewire`, `OnlineTrainer(rewire_schedule=)`, `--rewire`) held against the
JAX package on the same numpy inputs, and against its own oracles.

Tolerances and bars:
  * schedules, mask selections and migrations are bitwise: the selection is
    the reference's numpy code on the same scores, migration a gather;
  * RigL scores are dense one-step gradients, equal across frameworks to
    f32 round-off only: held within 1e-5 of each tensor's largest score,
    and the masks they select held bitwise only after asserting that every
    score near the selection boundary is bitwise equal across frameworks or
    the boundary's margin exceeds that tolerance;
  * SET draws `jax.random` uniforms in the reference, which torch cannot
    reproduce: parity tests hand both sides the reference's draw;
  * post-event gradients within 1e-5 of each tree's largest magnitude,
    against the JAX learner and against a fresh masked-dense learner on the
    new masks fed the migrated influence (the restart oracle).
"""
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sparsity as JDS
from repro.core import cells as JC, learner as JL
from repro.core import sparse_rtrl as JSP, stacked_rtrl as JST
from repro_torch import sparsity as DS
from repro_torch.sparsity import migrate as MG
from repro_torch.core import cells as C, sparse_rtrl as SP, stacked_rtrl as ST
from repro_torch.core.learner import LearnerSpec, make_learner
from repro_torch.launch import train as TRAIN
from repro_torch.optim import optimizers as O
from repro_torch.runtime import online as ON
from repro_torch.runtime.trainer import run_with_restart
from repro_torch.sparsity.schedule import RewireSchedule, key_generator
from repro_torch.tree import tree_flatten_with_path, tree_map
from repro_torch.weights import masks_from_numpy, params_from_numpy, to_numpy

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small tensors: one intra-op thread a test process, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return jax.tree.map(np.asarray, t)


def _jt(t):
    return jax.tree.map(jnp.asarray, t)


def _trees_close(got, want, rel=REL):
    got = jax.tree.leaves(to_numpy(got))
    want = jax.tree.leaves(_np(want))
    assert len(got) == len(want)
    scale = max(max(float(np.abs(w).max()) for w in want), 1e-3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale)


def _masks_equal(got, want):
    got = jax.tree.leaves(to_numpy(got))
    want = jax.tree.leaves(_np(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _setup(kind="gru", sparsity=0.5, seed=0, n=10, T=8, B=3, n_in=4):
    """The reference test's problem (JAX-drawn params and masks), as
    numpy."""
    jcfg = JC.EGRUConfig(n_hidden=n, n_in=n_in, n_out=2, kind=kind)
    cfg = C.EGRUConfig(n_hidden=n, n_in=n_in, n_out=2, kind=kind)
    params = JC.init_params(jcfg, jax.random.key(seed))
    masks = JSP.make_masks(jcfg, jax.random.key(seed + 7), sparsity)
    params = JSP.apply_masks(params, masks)
    xs = np.array(jax.random.normal(jax.random.key(seed + 1), (T, B, n_in)))
    labels = np.array([i % 2 for i in range(B)], np.int32)
    return jcfg, cfg, _np(params), _np(masks), xs, labels


def _jax_set_scores(masks, key, block=1):
    """The uniforms the reference's SET draws for each maskable tensor of
    a single-layer mask tree under `key`."""
    gates = tuple(g for g in masks
                  if g not in ("out", "theta") and masks[g] is not None)
    keys = JSP.gate_param_keys(key, gates)
    out = {}
    for g in gates:
        out[g] = {}
        for t in ("W", "R"):
            shape = tuple(s // block for s in np.shape(masks[g][t]))
            out[g][t] = np.asarray(jax.random.uniform(keys[g][t], shape))
    return out


# ---------------------------------------------------------------------------
# schedule and criteria
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(method="rigl", every_k=10, frac=0.4, t_end=8),
    dict(method="set", every_k=3, frac=0.3, t_end=None),
    dict(method="rigl", every_k=2, frac=0.3, t_end=0),
    dict(method="rigl", every_k=2, frac=0.3, t_end=10)])
def test_schedule_fires_and_fractions_equal_reference(kw):
    sch, jsch = RewireSchedule(**kw), JDS.RewireSchedule(**kw)
    assert [sch.fires(u) for u in range(60)] == \
        [jsch.fires(u) for u in range(60)]
    assert [sch.fraction(e) for e in range(20)] == \
        [jsch.fraction(e) for e in range(20)]


def test_schedule_validation_and_event_keys():
    for bad in (dict(method="magnitude"), dict(every_k=0)):
        with pytest.raises(ValueError):
            RewireSchedule(**bad)
        with pytest.raises(ValueError):
            JDS.RewireSchedule(**bad)
    k0, k1 = RewireSchedule.event_key(5, 0), RewireSchedule.event_key(5, 1)
    assert k0 != k1 and k0 == RewireSchedule.event_key(5, 0)
    # the draw depends on the key alone, not on any running RNG state
    a = torch.rand(4, generator=key_generator(k0 + (1, 2)))
    torch.rand(7)
    b = torch.rand(4, generator=key_generator(k0 + (1, 2)))
    assert torch.equal(a, b)
    assert not torch.equal(a, torch.rand(4, generator=key_generator(
        k1 + (1, 2))))


@pytest.mark.parametrize("block", [1, 4])
@pytest.mark.parametrize("method", ["rigl", "set"])
def test_rewire_tensor_bitwise(method, block):
    """One tensor: RigL on the same numpy grads, SET on the reference's own
    uniforms, fine and block-granular."""
    rng = np.random.default_rng(3)
    shape = (16, 8)
    coarse = rng.random((shape[0] // block, shape[1] // block)) >= 0.5
    mask = np.asarray(coarse[np.arange(16) // block][:, np.arange(8) // block],
                      np.float32)
    param = (rng.normal(size=shape) * mask).astype(np.float32)
    grad = rng.normal(size=shape).astype(np.float32)
    key = jax.random.key(11)
    want = np.asarray(JDS.rewire_tensor(mask, param, grad, frac=0.4, key=key,
                                        method=method, block=block))
    scores = np.asarray(jax.random.uniform(key, coarse.shape))
    got = DS.rewire_tensor(torch.from_numpy(mask), torch.from_numpy(param),
                           torch.from_numpy(grad), frac=0.4, method=method,
                           block=block, scores=scores)
    np.testing.assert_array_equal(to_numpy(got), want)
    assert got.sum() == mask.sum() and not np.array_equal(want, mask)


@pytest.mark.parametrize("block", [1, 4])
@pytest.mark.parametrize("method", ["rigl", "set"])
def test_rewire_masks_bitwise(method, block):
    jcfg = JC.EGRUConfig(n_hidden=16, n_in=8, kind="gru")
    masks = JSP.make_masks(jcfg, jax.random.key(0), 0.5, block=block)
    params = JSP.apply_masks(JC.init_params(jcfg, jax.random.key(1)), masks)
    w = JC.rec_param_tree(params)
    grads = jax.tree.map(lambda x: x + 1.0, w)
    key = jax.random.key(3)
    want = JDS.rewire_masks(masks, w, grads, frac=0.4, key=key,
                            method=method, block=block)
    got = DS.rewire_masks(
        masks_from_numpy(_np(masks), "cpu"), params_from_numpy(_np(w), "cpu"),
        params_from_numpy(_np(grads), "cpu"), frac=0.4, method=method,
        block=block, scores=_jax_set_scores(masks, key, block))
    _masks_equal(got, want)
    assert SP.omega_tilde(got) == pytest.approx(float(JSP.omega_tilde(masks)))


@pytest.mark.parametrize("method", ["rigl", "set"])
def test_rewire_stacked_masks_bitwise(method):
    jcfg = JC.stacked_config(JC.EGRUConfig(n_hidden=8, n_in=3, kind="gru"), 2)
    masks = JST.make_stacked_masks(jcfg, jax.random.key(0), 0.5)
    params = JST.apply_stacked_masks(
        JC.init_stacked_params(jcfg, jax.random.key(1)), masks)
    grads = jax.tree.map(lambda x: x * 2.0 - 0.1, params["layers"])
    key = jax.random.key(2)
    want = JDS.rewire_stacked_masks(masks, params["layers"], grads, frac=0.4,
                                    key=key, method=method)
    scores = [_jax_set_scores(masks[l], jax.random.fold_in(key, l))
              for l in range(2)]
    got = DS.rewire_stacked_masks(
        masks_from_numpy(_np(masks), "cpu"),
        params_from_numpy(_np(params["layers"]), "cpu"),
        params_from_numpy(_np(grads), "cpu"), frac=0.4, method=method,
        scores=scores)
    _masks_equal(got, want)


def test_rewire_criteria_refusals_and_invariants():
    cfg = C.EGRUConfig(n_hidden=16, n_in=8, kind="gru")
    gen = torch.Generator().manual_seed(0)
    masks = SP.make_masks(cfg, gen, 0.5, device="cpu")
    w = C.rec_param_tree(SP.apply_masks(
        C.init_params(cfg, torch.Generator().manual_seed(1), device="cpu"),
        masks))
    for kw, match in ((dict(method="set", block=4), "block-constant"),
                      (dict(method="set", block=3), "divisible"),
                      (dict(method="rigl"), "dense gradient")):
        with pytest.raises(ValueError, match=match):
            DS.rewire_masks(masks, w, frac=0.3, key=(0, 1), **kw)
    new = DS.rewire_masks(masks, w, frac=0.4, key=(0, 1), method="set")
    again = DS.rewire_masks(masks, w, frac=0.4, key=(0, 1), method="set")
    other = DS.rewire_masks(masks, w, frac=0.4, key=(0, 2), method="set")
    moved = 0.0
    for g in ("u", "r", "z"):
        for t in ("W", "R"):
            assert new[g][t].sum() == masks[g][t].sum()
            assert torch.equal(new[g][t], again[g][t])
            moved += float((new[g][t] != masks[g][t]).sum())
    assert moved > 0
    assert any(not torch.equal(new[g][t], other[g][t])
               for g in ("u", "r", "z") for t in ("W", "R"))
    layout = SP.flat_layout(cfg)
    assert SP.col_layout(layout, new, device="cpu").Pc == \
        SP.col_layout(layout, masks, device="cpu").Pc


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------

def _mask_pair(kind, n=12, n_in=4):
    jcfg = JC.EGRUConfig(n_hidden=n, n_in=n_in, kind=kind)
    masks = JSP.make_masks(jcfg, jax.random.key(0), 0.6)
    params = JSP.apply_masks(JC.init_params(jcfg, jax.random.key(1)), masks)
    new = JDS.rewire_masks(masks, JC.rec_param_tree(params), frac=0.4,
                           key=jax.random.key(2), method="set")
    return jcfg, C.EGRUConfig(n_hidden=n, n_in=n_in, kind=kind), masks, new


@pytest.mark.parametrize("kind", ["rnn", "gru"])
def test_migration_bitwise_against_reference_and_scatter_oracle(kind):
    """The plan, and the migration of vals [B, K, Pc_pad], of the full-row
    buffer [B, n, Pc_pad] and of gw [Pc_pad], bitwise equal to the JAX
    package's and to the port's scatter oracle; grown columns exactly 0."""
    jcfg, cfg, masks, new = _mask_pair(kind)
    jl, lay = JSP.flat_layout(jcfg), SP.flat_layout(cfg)
    jold, jnew = JSP.col_layout(jl, masks), JSP.col_layout(jl, new)
    old_cl = SP.col_layout(lay, masks_from_numpy(_np(masks), "cpu"),
                           device="cpu")
    new_cl = SP.col_layout(lay, masks_from_numpy(_np(new), "cpu"),
                           device="cpu")
    assert (new_cl.Pc, new_cl.Pc_pad) == (old_cl.Pc, old_cl.Pc_pad)
    plan = DS.migration_plan(old_cl, new_cl)
    jplan = JDS.migration_plan(jold, jnew)
    for got, want in zip(plan, jplan):
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    rng = np.random.default_rng(3)
    live = np.asarray(jold.live)
    grown = (np.asarray(jnew.live) > 0) & (np.asarray(jplan[1]) == 0)
    assert grown.any()
    for shape in ((2, 6, old_cl.Pc_pad), (2, 12, old_cl.Pc_pad),
                  (old_cl.Pc_pad,)):
        M = (rng.normal(size=shape) * live).astype(np.float32)
        got = DS.migrate_influence(old_cl, new_cl, torch.from_numpy(M), plan)
        want = np.asarray(JDS.migrate_influence(jold, jnew, jnp.asarray(M)))
        np.testing.assert_array_equal(to_numpy(got), want)
        np.testing.assert_array_equal(
            to_numpy(got), to_numpy(DS.migrate_via_flat(
                old_cl, new_cl, torch.from_numpy(M))))
        assert np.all(to_numpy(got)[..., grown] == 0.0)
    assert torch.equal(DS.migrate_influence(old_cl, old_cl,
                                            torch.from_numpy(M)),
                       torch.from_numpy(M))


def test_migration_stacked_shared_axis_bitwise():
    jcfg = JC.stacked_config(JC.EGRUConfig(n_hidden=8, n_in=3, kind="gru"), 2)
    cfg = C.stacked_config(C.EGRUConfig(n_hidden=8, n_in=3, kind="gru"), 2)
    masks = JST.make_stacked_masks(jcfg, jax.random.key(0), 0.5)
    params = JST.apply_stacked_masks(
        JC.init_stacked_params(jcfg, jax.random.key(1)), masks)
    new = JDS.rewire_stacked_masks(masks, params["layers"], frac=0.4,
                                   key=jax.random.key(2), method="set")
    jsl, sl = JST.stacked_layout(jcfg), ST.stacked_layout(cfg)
    jold, jnew = JST.stacked_col_layout(jsl, masks), \
        JST.stacked_col_layout(jsl, new)
    old_cl = ST.stacked_col_layout(sl, masks_from_numpy(_np(masks), "cpu"),
                                   device="cpu")
    new_cl = ST.stacked_col_layout(sl, masks_from_numpy(_np(new), "cpu"),
                                   device="cpu")
    plan = DS.migration_plan(old_cl, new_cl)
    for l in range(2):
        M = (np.random.default_rng(l).normal(size=(2, 4, old_cl.Pc_pad))
             * np.asarray(jold.live)).astype(np.float32)
        got = DS.migrate_influence(old_cl, new_cl, torch.from_numpy(M), plan)
        np.testing.assert_array_equal(
            to_numpy(got),
            np.asarray(JDS.migrate_influence(jold, jnew, jnp.asarray(M))))
        np.testing.assert_array_equal(
            to_numpy(got), to_numpy(DS.migrate_via_flat(
                old_cl, new_cl, torch.from_numpy(M))))


def test_migrate_dense_and_flat_match_reference():
    jcfg, cfg, masks, new = _mask_pair("gru")
    rng = np.random.default_rng(5)
    M = {g: rng.normal(size=(2, 12, 12, 17)).astype(np.float32)
         for g in ("u", "r", "z")}
    M["theta"] = rng.normal(size=(2, 12, 12)).astype(np.float32)
    got = DS.migrate_dense(cfg, {k: torch.from_numpy(v) for k, v in M.items()},
                           masks_from_numpy(_np(new), "cpu"))
    want = JDS.migrate_dense(jcfg, _jt(M), new)
    for g in M:
        np.testing.assert_array_equal(to_numpy(got[g]), np.asarray(want[g]))
    lay = SP.flat_layout(cfg)
    colm = SP.flat_col_mask(lay, masks_from_numpy(_np(new), "cpu"),
                            device="cpu")
    F = rng.normal(size=(2, 12, lay.P_pad)).astype(np.float32)
    np.testing.assert_array_equal(
        to_numpy(DS.migrate_flat(colm, torch.from_numpy(F))),
        np.asarray(JDS.migrate_flat(jnp.asarray(to_numpy(colm)),
                                    jnp.asarray(F))))


def test_prune_grow_prune_roundtrip_bitwise():
    """Columns that survive every event of a chain carry their values bit
    for bit (a composition of exact gathers)."""
    cfg = C.EGRUConfig(n_hidden=10, n_in=4, kind="gru")
    lay = SP.flat_layout(cfg)
    masks = SP.make_masks(cfg, torch.Generator().manual_seed(0), 0.5,
                          device="cpu")
    w = C.rec_param_tree(SP.apply_masks(
        C.init_params(cfg, torch.Generator().manual_seed(1), device="cpu"),
        masks))
    cl0 = SP.col_layout(lay, masks, device="cpu")
    M0 = torch.randn((2, 4, cl0.Pc_pad),
                     generator=torch.Generator().manual_seed(9)) * cl0.live
    cls, cur_masks, cur_M, cur_cl = [cl0], masks, M0, cl0
    for e in range(3):
        cur_masks = DS.rewire_masks(cur_masks, w, frac=0.3, key=(20, e),
                                    method="set")
        nxt = SP.col_layout(lay, cur_masks, device="cpu")
        cur_M = DS.migrate_influence(cur_cl, nxt, cur_M)
        cur_cl = nxt
        cls.append(nxt)

    def live_src(cl):
        return {int(s) for s, lv in zip(cl.src.tolist(), cl.live.tolist())
                if lv > 0}

    alive = live_src(cls[0]).intersection(*(live_src(c) for c in cls[1:]))
    assert alive
    first = to_numpy(SP.cols_to_flat(cls[0], M0))
    last = to_numpy(SP.cols_to_flat(cls[-1], cur_M))
    for s in alive:
        np.testing.assert_array_equal(last[..., s], first[..., s])


# ---------------------------------------------------------------------------
# the learners: against the JAX learner, and the restart oracle
# ---------------------------------------------------------------------------

def _assert_rigl_margin(got_scores, want_scores, old_masks, new_masks):
    """RigL scores within REL of each tensor's largest, and either the
    selection boundary's margin above 2 REL or the dead units near the
    boundary ranked in the same order by both frameworks (ties broken by
    unit index, as the selection breaks them): only then can the selected
    masks be held bitwise, since a near-tie could swap order under f32
    round-off."""
    got, want = to_numpy(got_scores), _np(want_scores)
    old, new = _np(old_masks), _np(new_masks)
    for g, t in [(g, t) for g in want if g != "theta" for t in ("W", "R")]:
        a, b = np.abs(got[g][t]), np.abs(want[g][t])
        tol = REL * max(float(b.max()), 1e-3)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
        grown = (new[g][t] > 0) & (old[g][t] == 0)
        rest = (new[g][t] == 0) & (old[g][t] == 0)
        if not grown.any() or not rest.any():
            continue
        lo, hi = b[grown].min(), b[rest].max()
        near = (np.abs(b - lo) <= 2 * tol) | (np.abs(b - hi) <= 2 * tol)
        near &= old[g][t] == 0
        same_order = np.array_equal(np.argsort(-a[near], kind="stable"),
                                    np.argsort(-b[near], kind="stable"))
        assert lo - hi > 2 * tol or same_order, (g, t, lo, hi, a[near],
                                                 b[near])


def _drive(learner, params, masks, xs, labels, t_split, rewire):
    carry = learner.init(params, masks, (xs[0], labels),
                         t_total=float(xs.shape[0]))
    for t in range(t_split):
        carry, _ = learner.step(carry, xs[t], labels)
    before = learner.reset_grads(carry)
    mid = rewire(learner, before)
    carry = mid
    for t in range(t_split, xs.shape[0]):
        carry, _ = learner.step(carry, xs[t], labels)
    return before, mid, learner.grads(carry)


def _port_and_jax(spec_kw, jcfg, cfg, params, masks, xs, labels, stacked):
    jspec = JL.LearnerSpec(cfg=jcfg, rewirable=True, interpret=True,
                           **spec_kw)
    spec = LearnerSpec(cfg=cfg, rewirable=True, **spec_kw)
    t_split = 4
    jl = JL.make_learner(jspec)
    jbefore, jmid, jgrads = _drive(
        jl, _jt(params), _jt(masks), jnp.asarray(xs), jnp.asarray(labels),
        t_split, lambda lr, c: lr.rewire(c, jax.random.key(42), frac=0.4,
                                         method="rigl"))
    tl = make_learner(spec)
    pm = [masks_from_numpy(m, "cpu") for m in masks] if stacked \
        else masks_from_numpy(masks, "cpu")
    before, mid, grads = _drive(
        tl, params_from_numpy(params, "cpu"), pm, torch.from_numpy(xs),
        torch.from_numpy(labels), t_split,
        lambda lr, c: lr.rewire(c, (42,), frac=0.4, method="rigl"))
    return (jl, jbefore, jmid, jgrads), (tl, before, mid, grads)


@pytest.mark.parametrize("backend,col", [
    ("dense", None), ("pallas", False), ("pallas", True),
    ("compact", False), ("compact", True)])
def test_rewired_learner_matches_reference(backend, col):
    """RigL event mid-sequence: the new masks bitwise and the post-event
    gradients within 1e-5 of the JAX learner's."""
    jcfg, cfg, params, masks, xs, labels = _setup(T=8)
    (jl, jbefore, jmid, jgrads), (tl, before, mid, grads) = _port_and_jax(
        dict(engine="sparse", backend=backend, col_compact=col), jcfg, cfg,
        params, masks, xs, labels, stacked=False)
    _assert_rigl_margin(tl._rigl_scores(before), jl._rigl_scores(jbefore),
                        masks, jmid["rw"]["masks"])
    _masks_equal(mid["rw"]["masks"], jmid["rw"]["masks"])
    _trees_close(mid["params"], jmid["params"])
    _trees_close(grads, jgrads)


@pytest.mark.parametrize("backend", ["dense", "pallas", "compact"])
def test_rewired_stacked_learner_matches_reference(backend):
    """`--layers 2`: per-layer RigL events on the shared column axis."""
    jcfg0, _, _, _, xs, labels = _setup(T=8)
    jcfg = JC.stacked_config(jcfg0, 2)
    cfg = C.stacked_config(C.EGRUConfig(n_hidden=10, n_in=4, n_out=2), 2)
    masks = JST.make_stacked_masks(jcfg, jax.random.key(7), 0.5)
    params = JST.apply_stacked_masks(
        JC.init_stacked_params(jcfg, jax.random.key(0)), masks)
    params, masks = _np(params), _np(masks)
    (jl, jbefore, jmid, jgrads), (tl, before, mid, grads) = _port_and_jax(
        dict(engine="stacked", backend=backend), jcfg, cfg, params, masks,
        xs, labels, stacked=True)
    for l, (got, want) in enumerate(zip(tl._rigl_scores(before),
                                        jl._rigl_scores(jbefore))):
        _assert_rigl_margin(got, want, masks[l], jmid["rw"]["masks"][l])
    _masks_equal(list(mid["rw"]["masks"]), list(jmid["rw"]["masks"]))
    _trees_close(grads, jgrads)


def _oracle_grads(learner, mid, xs, labels, t_split):
    """The restart oracle (`sparsity.migrate.restart_oracle`) stepped over the rest
    of the sequence."""
    oracle, oc = MG.restart_oracle(learner, mid)
    for t in range(t_split, xs.shape[0]):
        oc, _ = oracle.step(oc, xs[t], labels)
    return oracle.grads(oc)


def _port_problem(kind="gru", n=10, n_in=4, T=8, B=3, seed=0, sparsity=0.5):
    cfg = C.EGRUConfig(n_hidden=n, n_in=n_in, n_out=2, kind=kind)
    masks = SP.make_masks(cfg, torch.Generator().manual_seed(seed + 7),
                          sparsity, device="cpu")
    params = SP.apply_masks(C.init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu"), masks)
    xs = torch.randn((T, B, n_in),
                     generator=torch.Generator().manual_seed(seed + 1))
    labels = torch.arange(B) % 2
    return cfg, params, masks, xs, labels


@pytest.mark.parametrize("method", ["rigl", "set"])
@pytest.mark.parametrize("backend,col", [
    ("dense", None), ("pallas", False), ("pallas", True),
    ("compact", False), ("compact", True)])
def test_rewired_grads_equal_restart_oracle(backend, col, method):
    """Inside the port: post-event gradients equal a fresh masked-dense
    learner restarted on the new masks (grow-at-zero exactness), and grown
    weights are exactly 0 at the event."""
    cfg, params, masks, xs, labels = _port_problem()
    learner = make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                       backend=backend, col_compact=col,
                                       rewirable=True))
    _, mid, grads = _drive(learner, params, masks, xs, labels, 4,
                           lambda lr, c: lr.rewire(c, (42,), frac=0.4,
                                                   method=method))
    ref = _oracle_grads(learner, mid, xs, labels, 4)
    if backend == "dense":
        for a, b in zip(jax.tree.leaves(to_numpy(ref)),
                        jax.tree.leaves(to_numpy(grads))):
            np.testing.assert_array_equal(a, b)
    else:
        _trees_close(grads, to_numpy(ref))
    new = mid["rw"]["masks"]
    moved = 0
    for g in ("u", "r", "z"):
        for t in ("W", "R"):
            grown = (new[g][t] > 0) & (masks[g][t] == 0)
            moved += int(grown.sum())
            assert bool((mid["params"][g][t][grown] == 0).all())
    assert moved > 0


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("backend,col", [("dense", None), ("pallas", True),
                                         ("compact", True),
                                         ("compact", False)])
def test_stacked_rewired_grads_equal_restart_oracle(L, backend, col):
    """Stacked rewire (L=1 delegation and the L=2 engine): post-event
    gradients equal a fresh stacked dense learner restarted on the new
    masks with each layer's migrated influence scattered back."""
    cfg = C.stacked_config(C.EGRUConfig(n_hidden=10, n_in=4, n_out=2), L)
    masks = ST.make_stacked_masks(cfg, torch.Generator().manual_seed(7), 0.5,
                                  device="cpu")
    params = ST.apply_stacked_masks(C.init_stacked_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), masks)
    xs = torch.randn((8, 3, 4), generator=torch.Generator().manual_seed(1))
    labels = torch.arange(3) % 2
    learner = make_learner(LearnerSpec(engine="stacked", cfg=cfg,
                                       backend=backend, col_compact=col,
                                       rewirable=True))
    _, mid, grads = _drive(learner, params, masks, xs, labels, 4,
                           lambda lr, c: lr.rewire(c, (42,), frac=0.4))
    _trees_close(grads, to_numpy(_oracle_grads(learner, mid, xs, labels,
                                                4)))


@pytest.mark.parametrize("layers,col", [(1, True), (1, False), (2, True)])
def test_event_that_revives_a_dead_j_block_rebuilds_k2_masks(layers, col):
    """Hand-built masks whose R matrices are block diagonal at K2's 8 x 8
    granularity, so J's off-diagonal blocks are dead, and SET scores that
    grow R_u weights only into them; then an update moves the live
    weights.  The pallas learner must re-derive its J block masks from the
    new masks: left stale, K2 (its plain version here) skips the revived
    blocks, the grown weights' paths through J are lost, and the gradients
    leave the dense learner's."""
    n = 16
    cfg = C.stacked_config(C.EGRUConfig(n_hidden=n, n_in=2, n_out=2), layers)
    params = C.init_stacked_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    diag = torch.zeros((n, n))
    diag[:8, :8] = diag[8:, 8:] = 1.0
    rng = torch.Generator().manual_seed(5)
    masks = []
    for l in range(layers):
        n_in = cfg.layer_cfg(l).n_in
        mk = {g: {"W": (torch.rand((n_in, n), generator=rng) > 0.3).float(),
                  "R": diag * (torch.rand((n, n), generator=rng) > 0.4),
                  "b": torch.ones(n)} for g in ("u", "r", "z")}
        mk["theta"] = torch.ones(n)
        masks.append(mk)
    params = ST.apply_stacked_masks(params, masks)
    # SET scores: only the off-diagonal blocks of R_u score above 0
    off = 1.0 - to_numpy(diag)
    srng = np.random.default_rng(6)
    scores = []
    for l in range(layers):
        sc = {g: {"W": np.zeros(tuple(masks[l][g]["W"].shape)),
                  "R": np.zeros((n, n))} for g in ("u", "r", "z")}
        sc["u"]["R"] = off * (1.0 + srng.random((n, n)))
        scores.append(sc)
    xs = torch.randn((10, 4, 2), generator=torch.Generator().manual_seed(1))
    labels = torch.arange(4) % 2

    def rewire(lr, c):
        # the event, then an update-like step of every live weight: grown
        # weights start at exactly 0, so J's revived entries are non-zero
        # only once the optimizer has moved them
        c = lr.rewire(c, (1,), frac=0.5, method="set", scores=scores)
        gen = torch.Generator().manual_seed(8)
        mk, p = lr.opt_mask_of(c), lr.params_of(c)
        p["layers"] = [tree_map(lambda x, m: x + 0.5 * m * torch.randn(
            x.shape, generator=gen), pl, ml)
            for pl, ml in zip(p["layers"], mk["layers"])]
        return lr.reset_grads(c, p)

    spec = dict(engine="stacked", cfg=cfg, col_compact=col, rewirable=True)
    pallas = make_learner(LearnerSpec(backend="pallas", **spec))
    dense = make_learner(LearnerSpec(backend="dense", **spec))
    pallas.init(params, masks, (xs[0], labels), t_total=10.0)
    kmasks = lambda: [pallas.inner._kmasks] if layers == 1 \
        else pallas._kmasks
    assert not any(bool(km[1].all()) for km in kmasks())
    _, mid, grads = _drive(pallas, params, masks, xs, labels, 3, rewire)
    _, _, want = _drive(dense, params, masks, xs, labels, 3, rewire)
    for km in kmasks():
        assert bool(km[1].all()), "a revived J block is still dead"
    new_masks = pallas.opt_mask_of(mid)["layers"]
    assert all(bool((nm["u"]["R"] * (1 - diag)).any()) for nm in new_masks)
    _trees_close(grads, to_numpy(want))


# ---------------------------------------------------------------------------
# the online trainer and the launcher
# ---------------------------------------------------------------------------

def _rewire_trainer_factory(tmp_path, fail_at=-1, total_steps=30,
                            method="rigl", backend="compact", layers=1):
    cfg = C.stacked_config(C.EGRUConfig(n_hidden=8, n_in=3, n_out=2), layers)
    masks = ST.make_stacked_masks(cfg, torch.Generator().manual_seed(7), 0.5,
                                  device="cpu")
    learner = make_learner(LearnerSpec(engine="stacked", cfg=cfg,
                                       backend=backend, rewirable=True))
    opt = O.masked_dynamic(O.make_optimizer("adamw", lr=1e-2),
                           {"layers": masks, "out": None})
    sched = RewireSchedule(method=method, every_k=3, frac=0.3, t_end=4)

    def stream(step):
        rng = np.random.default_rng(1000 + step % 20)
        return (rng.normal(size=(4, 3)).astype(np.float32),
                (np.arange(4) % 2).astype(np.int32))

    def make_trainer(attempt=0):
        params = ST.apply_stacked_masks(C.init_stacked_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"), masks)
        ocfg = ON.OnlineTrainerConfig(
            total_steps=total_steps, update_every=3, ckpt_every=2,
            ckpt_dir=str(tmp_path), log_every=1,
            fail_at_update=fail_at if attempt == 0 else -1)
        return ON.OnlineTrainer(ocfg, learner, opt, params, masks, stream,
                                device="cpu", rewire_schedule=sched)

    return make_trainer


def _ckpt_leaves(root, like):
    from repro_torch.checkpoint import load_checkpoint
    tree, _ = load_checkpoint(root, like)
    return {"__".join(map(str, p)): to_numpy(x) if isinstance(
        x, torch.Tensor) else np.asarray(x)
        for p, x in tree_flatten_with_path(tree)}


@pytest.mark.parametrize("backend,layers", [("compact", 1), ("pallas", 1),
                                            ("pallas", 2)])
def test_online_rewire_restart_resumes_identical_masks(backend, layers,
                                                       tmp_path):
    """A crash between events (update 7; events at 3 and 6 fired), restart,
    resume: the final checkpoint — masks, layout, carry, optimizer mask and
    moments — is bitwise the uninterrupted run's."""
    out_a = run_with_restart(_rewire_trainer_factory(
        tmp_path / "a", fail_at=7, backend=backend, layers=layers))
    out_b = run_with_restart(_rewire_trainer_factory(
        tmp_path / "b", backend=backend, layers=layers))
    assert (out_a["restarts"], out_b["restarts"]) == (1, 0)
    assert out_a["rewire_events"] == out_b["rewire_events"] == 3
    like = _rewire_trainer_factory(tmp_path / "like", backend=backend,
                                   layers=layers)()._ckpt_tree()
    a, b = _ckpt_leaves(tmp_path / "a", like), _ckpt_leaves(tmp_path / "b",
                                                           like)
    assert a.keys() == b.keys()
    assert any("rw__masks" in k for k in a) and any("opt__mask" in k
                                                   for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_online_rewire_moves_masks_and_prices_live_bytes(tmp_path):
    """Events change the masks at constant density, and the trainer reports
    the LIVE carry footprint (vals priced at Pc, not Pc_pad)."""
    from repro_torch.core.costs import carry_footprint
    t = _rewire_trainer_factory(tmp_path, total_steps=30)()
    m0 = to_numpy(t.carry["rw"]["masks"])
    out = t.run()
    assert out["rewire_events"] == 3
    m1 = t.carry["rw"]["masks"]
    assert any(not np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(m0), jax.tree.leaves(to_numpy(m1))))
    assert SP.omega_tilde(m1) == pytest.approx(SP.omega_tilde(
        masks_from_numpy(m0, "cpu")))
    events = [m for m in out["metrics"] if "rewire_event" in m]
    assert [m["rewire_event"] for m in events] == [0, 1, 2]
    fp = t.carry_nbytes()
    assert fp["live"] < fp["alloc"] and 0.0 < fp["col_density"] < 1.0
    vals = t.carry["vals"]
    n_cols = vals.shape[-1]
    n_live = int(t.carry["rw"]["cl"]["live"].sum())
    d = carry_footprint(1, vals.numel() // n_cols, n_cols, n_live)
    assert fp["alloc"] - fp["live"] == d["alloc_bytes"] - d["live_bytes"]
    assert out["carry_live_bytes"] == fp["live"] == events[-1][
        "carry_live_bytes"]


def test_carry_nbytes_prices_stacked_layers_individually(tmp_path):
    from repro_torch.core.costs import carry_footprint
    t = _rewire_trainer_factory(tmp_path, layers=2)()
    fp = t.carry_nbytes()
    live_v, layer_v = t.carry["rw"]["cl"]["live"], t.carry["rw"]["cl"]["layer"]
    n_cols = live_v.shape[-1]
    expect = fp["alloc"]
    for l, b in enumerate(t.carry["vals"]):
        nl = int((live_v * (layer_v <= l)).sum())
        d = carry_footprint(1, b.numel() // n_cols, n_cols, nl)
        expect += d["live_bytes"] - d["alloc_bytes"]
    assert fp["live"] == expect < fp["alloc"]


def test_rewire_refusals():
    cfg, params, masks, xs, labels = _port_problem()
    with pytest.raises(ValueError, match="rewirable=True"):
        make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                 backend="compact_fused", rewirable=True))
    plain = make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                     backend="compact"))
    carry = plain.init(params, masks, (xs[0], labels))
    with pytest.raises(NotImplementedError, match="rewirable"):
        plain.rewire(carry, (0,))
    bptt = make_learner(LearnerSpec(engine="bptt", cfg=cfg))
    with pytest.raises(NotImplementedError, match="sparse"):
        bptt.rewire({}, (0,))
    with pytest.raises(ValueError, match="masks"):
        make_learner(LearnerSpec(engine="sparse", cfg=cfg, backend="compact",
                                 rewirable=True)).init(params, None,
                                                       (xs[0], labels))
    stream = lambda t: (np.zeros((3, 4), np.float32), np.zeros(3, np.int32))
    sch = RewireSchedule(every_k=3)
    rew = make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                   backend="compact", rewirable=True))
    with pytest.raises(ValueError, match="masked_dynamic"):
        ON.OnlineTrainer(ON.OnlineTrainerConfig(), rew,
                         O.masked(O.make_optimizer("adamw"), dict(masks)),
                         params, masks, stream, device="cpu",
                         rewire_schedule=sch)
    with pytest.raises(ValueError, match="rewirable"):
        ON.OnlineTrainer(ON.OnlineTrainerConfig(), plain,
                         O.masked_dynamic(O.make_optimizer("adamw"),
                                          dict(masks)),
                         params, masks, stream, device="cpu",
                         rewire_schedule=sch)
    with pytest.raises(ValueError, match="masked_dynamic state"):
        O.set_opt_mask({"m": {}}, {})


@pytest.mark.parametrize("extra,message", [
    (["--rtrl-backend", "compact_fused"], "compact_fused backend"),
    (["--sparsity", "0"], "--sparsity > 0"),
    (["--no-online"], "needs --online")])
def test_launcher_rewire_refusals_as_reference(extra, message):
    argv = ["--arch", "egru-spiral", "--online", "--sparsity", "0.8",
            "--device", "cpu", "--rewire", "rigl", "--ckpt-every", "0"]
    if extra == ["--no-online"]:
        argv.remove("--online")
        extra = []
    from repro_torch.kernels import compact_fused as CF
    before = CF.fused_update.launches
    with pytest.raises(SystemExit, match=message):
        TRAIN.main(argv + extra)
    assert CF.fused_update.launches == before


@pytest.mark.parametrize("layers", [1, 2])
def test_launcher_rewire_runs_and_keeps_live_counts(layers, capsys):
    out = TRAIN.main(["--arch", "egru-spiral", "--online", "--sparsity",
                      "0.8", "--device", "cpu", "--rtrl-backend", "pallas",
                      "--rewire", "rigl", "--rewire-every", "2", "--steps",
                      "4", "--ckpt-every", "0", "--layers", str(layers)])
    s = out["summary"]
    assert (s["rewire"], s["rewire_events"], s["updates"]) == ("rigl", 2, 4)
    assert s["carry_live_bytes"] < s["carry_bytes"]
    assert np.isfinite([w["loss"] for w in out["windows"]]).all()
    assert '"rewire_events": 2' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# a JAX-written rewired checkpoint, resumed in the port
# ---------------------------------------------------------------------------

class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def jax_rewire_run():
    """What the JAX launcher hands its OnlineTrainer for `--arch
    egru-spiral --online --rtrl-backend compact --sparsity 0.8 --rewire
    rigl --rewire-every 2`."""
    from repro.launch import train as JTRAIN
    from repro.runtime import online as JON
    captured = {}

    def fake_trainer(ocfg, learner, opt, params, masks, stream, **kw):
        captured.update(learner=learner, opt=opt, params=params, masks=masks,
                        stream=stream, **kw)
        raise _Captured

    argv = ["train", "--arch", "egru-spiral", "--online", "--rtrl-backend",
            "compact", "--sparsity", "0.8", "--seed", "0", "--rewire", "rigl",
            "--rewire-every", "2", "--steps", "3"]
    mp = pytest.MonkeyPatch()
    mp.setattr(JON, "OnlineTrainer", fake_trainer)
    mp.setattr(sys, "argv", argv)
    try:
        with pytest.raises(_Captured):
            JTRAIN.main()
    finally:
        mp.undo()
    return captured


def test_reference_rewired_checkpoint_resumes_in_the_port(jax_rewire_run,
                                                          tmp_path):
    """The JAX trainer's checkpoint after update 2 (event 0 fired) resumes
    in the port: the masks equal, and the third window's loss and params
    within 1e-5 of the JAX trainer's."""
    from repro.runtime import online as JON
    run = jax_rewire_run
    jt = JON.OnlineTrainer(
        JON.OnlineTrainerConfig(total_steps=24, update_every=8, ckpt_every=2,
                                ckpt_dir=str(tmp_path / "jax"), log_every=1),
        run["learner"], run["opt"], run["params"], run["masks"],
        run["stream"], rewire_schedule=run["rewire_schedule"])
    jout = jt.run()
    assert jout["rewire_events"] == 1
    shutil.copytree(tmp_path / "jax" / "step_00000002",
                    tmp_path / "port" / "step_00000002")
    cfg = C.stacked_config(C.EGRUConfig(), 1)
    masks = [masks_from_numpy(m, "cpu") for m in _np(run["masks"])]
    learner = make_learner(LearnerSpec(engine="stacked", cfg=cfg,
                                       backend="compact", rewirable=True))
    opt = O.masked_dynamic(O.make_optimizer("adamw", lr=cfg.lr),
                           {"layers": masks, "out": None})
    sch = run["rewire_schedule"]
    tr = ON.OnlineTrainer(
        ON.OnlineTrainerConfig(total_steps=24, update_every=8, ckpt_every=2,
                               ckpt_dir=str(tmp_path / "port"), log_every=1),
        learner, opt, params_from_numpy(_np(run["params"]), "cpu"), masks,
        run["stream"], device="cpu",
        rewire_schedule=RewireSchedule(method=sch.method, every_k=sch.every_k,
                                       frac=sch.frac, t_end=sch.t_end))
    assert tr.try_resume()
    assert (tr.update, tr.step, tr.rewire_events) == (2, 16, 1)
    jmasks = jt.carry["rw"]["masks"]
    _masks_equal(tr.carry["rw"]["masks"], jmasks)
    _masks_equal(tr.opt_state["mask"], jt.opt_state["mask"])
    assert not all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
                   zip(jax.tree.leaves(jmasks),
                       jax.tree.leaves(run["masks"][0])))
    out = tr.run()
    assert [m["update"] for m in out["metrics"]] == [3]
    np.testing.assert_allclose(out["metrics"][0]["loss"],
                               jout["metrics"][2]["loss"], rtol=REL)
    _trees_close(tr.learner.params_of(tr.carry),
                 run["learner"].params_of(jt.carry))


def test_rewire_keeps_a_bf16_carry_bf16():
    """Migration keeps the carry's dtype: a bf16 compact carry stays bf16
    (and its surviving columns bitwise) across an event.  The JAX package
    widens it to float32 at its first event (ROADMAP Queue 3)."""
    cfg, params, masks, xs, labels = _port_problem()
    learner = make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                       backend="compact", col_compact=True,
                                       rewirable=True,
                                       influence_dtype="bfloat16"))
    carry = learner.init(params, masks, (xs[0], labels), t_total=8.0)
    for t in range(4):
        carry, _ = learner.step(carry, xs[t], labels)
    old_cl = learner._cl
    new = learner.rewire(learner.reset_grads(carry), (3,), frac=0.4,
                         method="set")
    assert new["vals"].dtype == torch.bfloat16
    assert torch.equal(new["vals"], DS.migrate_via_flat(
        old_cl, learner._cl, carry["vals"].float()).to(torch.bfloat16))
