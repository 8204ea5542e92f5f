"""The port's scaled sparse-RTRL engine (`repro_torch.core.scaled_rtrl`,
`core.learner.ScaledLearner`) held against the JAX package on the same
numpy params, masks and inputs, and against the port's own oracles (the
masked-dense step, BPTT on the surviving parameters).

Parameters and masks are drawn by the JAX package and carried across
through `weights.params_from_numpy` / `masks_from_numpy`; inputs come
from a numpy seed.  Tolerances: f32 losses, gradients and influence values
within 1e-5 of the largest magnitude of their tree or array (the compact
influence against the dense step within 1e-6, as in the reference's own
test); a bf16 carry within 4e-3 of the largest magnitude of the reference
(one bf16 step, 2^-8) and 2e-2 of BPTT's; activity, indices, overflow and
layouts exactly; inside the port the online path equals the offline one,
and a rewired carry a fresh engine, bit for bit.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.core import learner as JL, scaled_rtrl as JSR
from repro.runtime import online as JON
from repro_torch.core import bptt, cells as C, scaled_rtrl as SR
from repro_torch.core import sparse_rtrl as SP, stacked_rtrl as ST
from repro_torch.core.learner import LearnerSpec, make_learner
from repro_torch.kernels import compact_fused as CF
from repro_torch.optim import optimizers as O
from repro_torch.runtime import online as ON
from repro_torch.runtime.trainer import run_with_restart
from repro_torch.tree import tree_leaves
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


def _cfgs(**kw):
    return JSR.ScaledRTRLConfig(**kw), SR.ScaledRTRLConfig(**kw)


def _setup(n=48, n_in=12, B=3, L=1, capacity=1.0, sparsity=0.8, T=8,
           seed=0, scale=1.0):
    """(reference cfg, port cfg, JAX params, JAX masks, port params, port
    masks, xs [T, B, n_in] numpy N(0, scale^2), labels [B])."""
    jcfg, cfg = _cfgs(n=n, n_in=n_in, batch=B, n_layers=L,
                      beta_capacity=capacity, sparsity=sparsity)
    jp, jm = JSR.init_params(jcfg, jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    np_masks = jax.tree.map(np.asarray, jm)
    tm = ([masks_from_numpy(m, "cpu") for m in np_masks] if L > 1
          else masks_from_numpy(np_masks, "cpu"))
    rng = np.random.default_rng(seed + 1)
    xs = (scale * rng.standard_normal((T, B, n_in))).astype(np.float32)
    labels = (np.arange(B) % cfg.n_out).astype(np.int32)
    return jcfg, cfg, jp, jm, tp, tm, xs, labels


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-3)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _trees_close(got, want, rel=REL, what=""):
    """Every leaf within rel of the largest magnitude of the tree."""
    got = jax.tree.leaves(to_numpy(got))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(got) == len(want)
    scale = max(max(float(np.abs(w).max()) for w in want), 1e-3)
    for g, w in zip(got, want):
        assert g.shape == w.shape, what
        err = float(np.abs(np.float64(g) - np.float64(w)).max())
        assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _masked(cfg, grads, masks):
    if cfg.n_layers > 1:
        return ST.apply_stacked_masks(grads, masks)
    return SP.apply_masks(grads, masks)


# ---------------------------------------------------------------------------
# config and state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,cap", [(1024, 0.25), (1024, 0.5), (1024, 1.0),
                                   (48, 1.0), (20, 1.0), (16, 0.1),
                                   (100, 0.33)])
def test_config_K_and_m_equal_the_reference(n, cap):
    """The reference's K (8-aligned, neither capped at n nor floored at 8:
    n 20 at capacity 1 gives K 24) and m; the state's shapes on the meta
    device, K <= 0.27 n at capacity 0.25 (memory beta~ n p, not n p)."""
    jcfg, cfg = _cfgs(n=n, beta_capacity=cap)
    assert (cfg.K, cfg.m) == (jcfg.K, jcfg.m)
    assert cfg.layout() == SP.flat_layout(cfg.cell_cfg())
    assert cfg.layout().P_pad == jcfg.layout().P_pad
    st = SR.init_state(cfg, device="meta")
    assert st["vals"].shape == (cfg.batch, cfg.K, cfg.layout().P_pad)
    assert st["idx"].shape == (cfg.batch, cfg.K)
    assert st["a"].shape == (cfg.batch, n)
    if (n, cap) == (1024, 0.25):
        assert cfg.K <= 0.27 * cfg.n
    if n == 20:
        assert cfg.K == 24 > SP.capacity_K(n, cap) == 20


@pytest.mark.parametrize("L", [1, 2])
def test_col_layout_and_stacked_state_equal_the_reference(L):
    jcfg, cfg, jp, jm, tp, tm, _, _ = _setup(n=32, n_in=8, L=L,
                                             sparsity=0.9)
    jcl, cl = jcfg.col_layout(jm), cfg.col_layout(tm, device="cpu")
    assert (cl.Pc, cl.Pc_pad, cl.P_pad) == (jcl.Pc, jcl.Pc_pad, jcl.P_pad)
    for f in ("src", "layer", "gate", "q", "j", "live"):
        np.testing.assert_array_equal(getattr(cl, f).numpy(),
                                      np.asarray(getattr(jcl, f)))
    st = SR.init_state(cfg, cl, "bfloat16", device="cpu")
    jst = JSR.init_state(jcfg, jcl, "bfloat16")
    for a, b in zip(jax.tree.leaves(to_numpy(st)), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(a, np.asarray(b, a.dtype))
    assert tree_leaves(st["vals"])[0].dtype == torch.bfloat16
    if L > 1:
        assert isinstance(st["a"], tuple) and len(st["vals"]) == L
    # the shardings over a mesh: the reference's specs on the same mesh
    from jax.sharding import AbstractMesh
    jst, jx = JSR.sharded_step_specs(jcfg, AbstractMesh((2, 4),
                                                        ("data", "model")))
    st, x = SR.sharded_step_specs(cfg, {"data": 2, "model": 4})
    assert x.spec == tuple(jx.spec)
    for k in ("a", "vals", "idx"):
        got = st[k] if L > 1 else (st[k],)
        want = jst[k] if L > 1 else (jst[k],)
        assert [g.spec for g in got] == [tuple(w.spec) for w in want]


def test_init_params_draws_masked_params_from_the_generator():
    cfg = SR.ScaledRTRLConfig(n=32, n_in=8, batch=2, sparsity=0.75)
    p1, m1 = SR.init_params(cfg, torch.Generator().manual_seed(5),
                            device="cpu")
    p2, m2 = SR.init_params(cfg, torch.Generator().manual_seed(5),
                            device="cpu")
    _trees_equal(p1, p2)
    R, mR = p1["v"]["R"], m1["v"]["R"]
    assert torch.equal(R, R * mR)
    # 8 x 8 blocks: every block all live or all dead
    blocks = mR.reshape(4, 8, 4, 8).sum(dim=(1, 3))
    assert set(blocks.unique().tolist()) <= {0.0, 64.0}
    assert 0.0 < float(mR.mean()) < 1.0


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("col", [False, True])
def test_compact_step_equals_dense_step_and_the_reference(col):
    """6 steps at the reference's _setup: `a` and the overflow equal the
    reference's exactly, the compact carry its own masked-dense step
    (compact_to_dense_M) within 1e-6, and the reference's compact carry."""
    jcfg, cfg, jp, jm, tp, tm, xs, _ = _setup(T=6)
    jcl = jcfg.col_layout(jm) if col else None
    cl = cfg.col_layout(tm, device="cpu") if col else None
    w = C.rec_param_tree(tp)
    jw = {k: v for k, v in jp.items() if k != "out"}
    state, jstate = SR.init_state(cfg, cl, device="cpu"), \
        JSR.init_state(jcfg, jcl)
    a = torch.zeros((cfg.batch, cfg.n))
    M = torch.zeros((cfg.batch, cfg.n, cfg.n, cfg.m))
    for t in range(6):
        x = torch.from_numpy(xs[t])
        state, ov = SR.compact_step(cfg, w, state, x, cl=cl)
        jstate, jov = JSR.compact_step(jcfg, jw, jstate, jnp.asarray(xs[t]),
                                       cl=jcl)
        a, M = SR.dense_step(cfg, w, a, M, x)
        np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
        assert int(ov.max()) == 0
        np.testing.assert_array_equal(state["a"].numpy(),
                                      np.asarray(jstate["a"]))
        np.testing.assert_array_equal(state["idx"].numpy(),
                                      np.asarray(jstate["idx"]))
    assert torch.equal(state["a"], a)
    if col:   # the column-compact carry holds the live columns only
        layout = cfg.layout()
        live = SP.flat_col_mask(layout, tm, device="cpu")[:layout.P]
        M = M * live.reshape(cfg.n, cfg.m)
    Mc = SR.compact_to_dense_M(cfg, state, cl)
    np.testing.assert_allclose(Mc.numpy(), M.numpy(), atol=1e-6, rtol=0)
    _close(Mc, np.asarray(JSR.compact_to_dense_M(jcfg, jstate, jcl)),
           what="M")


# ---------------------------------------------------------------------------
# whole-sequence gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparsity", [0.5, 0.9])
@pytest.mark.parametrize("col", [False, True])
@pytest.mark.parametrize("L", [1, 2])
def test_rtrl_grads_equal_the_reference_and_bptt(L, col, sparsity, dtype):
    """rtrl_grads against the reference's rtrl_grads and against the port's
    BPTT oracle on the surviving parameters; no step overflows."""
    shape = dict(n=48, n_in=12) if L == 1 else dict(n=32, n_in=8)
    jcfg, cfg, jp, jm, tp, tm, xs, labels = _setup(
        **shape, L=L, sparsity=sparsity, T=8 if L == 1 else 6)
    loss, grads, stats = SR.rtrl_grads(
        cfg, tp, torch.from_numpy(xs), torch.from_numpy(labels), tm,
        col_compact=col, influence_dtype=dtype)
    jloss, jgrads, jstats = JSR.rtrl_grads(
        jcfg, jp, jnp.asarray(xs), jnp.asarray(labels), jm, col_compact=col,
        influence_dtype=dtype)
    assert int(stats["overflow"].max()) == 0
    np.testing.assert_array_equal(stats["overflow"].numpy(),
                                  np.asarray(jstats["overflow"]))
    ref_rel, bptt_rel = (REL, REL) if dtype == "float32" else (4e-3, 2e-2)
    _close(loss, np.asarray(jloss), what="loss")
    _trees_close(grads, jgrads, ref_rel, "vs reference")
    if L == 1:
        bl, bg, _ = bptt.bptt_loss_and_grads(
            cfg.cell_cfg(), tp, torch.from_numpy(xs),
            torch.from_numpy(labels))
    else:
        bl, bg, _ = bptt.stacked_bptt_loss_and_grads(
            cfg.stacked_cfg(), tp, torch.from_numpy(xs),
            torch.from_numpy(labels))
    _close(loss, bl.numpy(), what="loss vs BPTT")
    _trees_close(_masked(cfg, grads, tm), to_numpy(_masked(cfg, bg, tm)),
                 bptt_rel, "vs BPTT")


@pytest.fixture
def counted_plain_k1(monkeypatch):
    """The plain K1 (`fused_reference`, what the wrapper runs on CPU
    tensors) counting its calls."""
    calls = [0]
    plain = CF.fused_reference

    def counting(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(CF, "fused_reference", counting)
    return calls


@pytest.mark.parametrize("L", [1, 2])
def test_fused_equals_compact_with_one_k1_call_a_layer_a_step(
        L, counted_plain_k1):
    jcfg, cfg, jp, jm, tp, tm, xs, labels = _setup(
        n=16, n_in=5, B=3, L=L, sparsity=0.7, T=5, seed=3)
    args = (cfg, tp, torch.from_numpy(xs), torch.from_numpy(labels), tm)
    lc, gc, _ = SR.rtrl_grads(*args)
    assert counted_plain_k1[0] == 0
    lf, gf, st = SR.rtrl_grads(*args, backend="compact_fused")
    assert counted_plain_k1[0] == 5 * L
    assert int(st["overflow"].max()) == 0
    _close(lf, lc.numpy(), what="loss")
    _trees_close(gf, to_numpy(gc), what="fused vs compact")
    jl, jg, _ = JSR.rtrl_grads(jcfg, jp, jnp.asarray(xs), jnp.asarray(labels),
                               jm)
    _trees_close(gf, jg, what="fused vs reference compact")


@pytest.mark.parametrize("L", [1, 2])
def test_overflow_trace_at_capacity_one_quarter_equals_the_reference(L):
    """At capacity 0.25 the rows past K are dropped in both packages the
    same way: the overflow trace is the reference's, and so are the (no
    longer exact) loss and gradients."""
    shape = dict(n=48, n_in=12) if L == 1 else dict(n=32, n_in=8)
    jcfg, cfg, jp, jm, tp, tm, xs, labels = _setup(
        **shape, L=L, capacity=0.25, T=8, scale=2.0)
    loss, grads, stats = SR.rtrl_grads(
        cfg, tp, torch.from_numpy(xs), torch.from_numpy(labels), tm)
    jloss, jgrads, jstats = JSR.rtrl_grads(
        jcfg, jp, jnp.asarray(xs), jnp.asarray(labels), jm)
    ov = stats["overflow"].numpy()
    np.testing.assert_array_equal(ov, np.asarray(jstats["overflow"]))
    assert ov.shape == ((8,) if L == 1 else (8, L)) and ov.max() > 0
    _close(loss, np.asarray(jloss), what="loss")
    _trees_close(grads, jgrads, what="grads")


def test_compact_step_flops_scale_as_K_squared():
    """The counterpart of the reference's cost-analysis test: the
    products' FLOPs of one compact step (FlopCounterMode) at capacity 0.5
    are < 0.45 of those at capacity 1 (~ (K/K')^2 plus the cell's own)."""
    def flops(capacity):
        cfg = SR.ScaledRTRLConfig(n=64, n_in=12, batch=3,
                                  beta_capacity=capacity, sparsity=0.8)
        params, _ = SR.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
        state = SR.init_state(cfg, device="cpu")
        with FlopCounterMode(display=False) as fc:
            SR.compact_step(cfg, C.rec_param_tree(params), state,
                            torch.zeros((cfg.batch, cfg.n_in)))
        return fc.get_total_flops()

    f_full, f_half = flops(1.0), flops(0.5)
    assert f_full > 0 and f_half / f_full < 0.45, (f_half, f_full)


# ---------------------------------------------------------------------------
# the learner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("col,backend", [(False, "compact"),
                                         (True, "compact"),
                                         (True, "compact_fused")])
@pytest.mark.parametrize("L", [1, 2])
def test_online_equals_offline_bitwise(L, col, backend):
    """The learner stepped online over a window (`stream_grads`) equals the
    whole-sequence rtrl_grads bit for bit; its loss and gradients equal
    the reference learner's (compact_fused is column-compact by
    construction)."""
    jcfg, cfg, jp, jm, tp, tm, xs, labels = _setup(
        n=16, n_in=4, B=2, L=L, sparsity=0.5, T=6)
    txs, tl = torch.from_numpy(xs), torch.from_numpy(labels)
    l_ref, g_ref, s_ref = SR.rtrl_grads(cfg, tp, txs, tl, tm,
                                        col_compact=col, backend=backend)
    learner = make_learner(LearnerSpec(engine="scaled", cfg=cfg,
                                       col_compact=col, backend=backend))
    carry = learner.init(tp, tm, (txs[0], tl), t_total=6.0)
    carry, loss, grads, stats = ON.stream_grads(
        learner, carry, txs, tl[None].expand(6, -1))
    assert float(loss) == float(l_ref)
    _trees_equal(grads, g_ref)
    assert torch.equal(stats["overflow"], s_ref["overflow"])
    jl = JL.make_learner(JL.LearnerSpec(engine="scaled", cfg=jcfg,
                                        col_compact=col))
    jloss, jgrads, _ = JL.scan_learner(jl, jp, jm, jnp.asarray(xs),
                                       jnp.asarray(labels))
    _close(loss, np.asarray(jloss), what="loss")
    _trees_close(grads, jgrads, what="grads")


def _rewired(cfg, tp, tm, xs, labels, method, dtype):
    """4 steps of a rewirable learner, the accumulators reset (an update
    boundary), one event: (learner, carry after the event)."""
    learner = make_learner(LearnerSpec(engine="scaled", cfg=cfg,
                                       col_compact=True, rewirable=True,
                                       influence_dtype=dtype))
    carry = learner.init(tp, tm, (xs[0], labels), t_total=float(len(xs)))
    for t in range(4):
        carry, _ = learner.step(carry, xs[t], labels)
    carry = learner.reset_grads(carry)
    return learner, learner.rewire(carry, (0, 42), frac=0.5, method=method,
                                   block=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["rigl", "set"])
@pytest.mark.parametrize("L", [1, 2])
def test_rewired_carry_equals_a_fresh_engine_on_the_new_masks(L, method,
                                                              dtype):
    """After one event the rewired learner continues bit for bit as a fresh
    scaled engine built on the new masks with the migrated state; a bf16
    carry stays bf16 through the event (fault 4)."""
    cfg = SR.ScaledRTRLConfig(n=16, n_in=4, n_out=2, batch=2, n_layers=L,
                              beta_capacity=1.0, sparsity=0.5, mask_block=2)
    tp, tm = SR.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(1)
    txs = torch.from_numpy(rng.standard_normal((8, 2, 4)).astype(np.float32))
    tl = torch.tensor([0, 1])
    learner, mid = _rewired(cfg, tp, tm, txs, tl, method, dtype)
    new_masks = mid["rw"]["masks"]
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(new_masks), tree_leaves(tm)))
    for v in tree_leaves(mid["state"]["vals"]):
        assert v.dtype == SP.influence_carry_dtype(dtype)
    fresh = make_learner(LearnerSpec(engine="scaled", cfg=cfg,
                                     col_compact=True, influence_dtype=dtype))
    fc = fresh.init(mid["params"], list(new_masks) if L > 1 else new_masks,
                    (txs[0], tl), t_total=8.0)
    fc["state"] = mid["state"]
    c2 = mid
    for t in range(4, 8):
        c2, _ = learner.step(c2, txs[t], tl)
        fc, _ = fresh.step(fc, txs[t], tl)
    _trees_equal(learner.grads(c2), fresh.grads(fc))
    _trees_equal(c2["state"], fc["state"])
    assert learner.opt_mask_of(c2) is not None


def _scaled_trainer(cfg, tp, tm, root, *, fail_at=-1, backend="compact"):
    learner = make_learner(LearnerSpec(engine="scaled", cfg=cfg,
                                       backend=backend))
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((64, cfg.batch, cfg.n_in)).astype(np.float32)
    ys = (np.arange(64 * cfg.batch).reshape(64, cfg.batch)
          % cfg.n_out).astype(np.int32)
    opt = O.masked(O.adamw(lr=1e-3), {**tm, "out": None})
    return ON.OnlineTrainer(
        ON.OnlineTrainerConfig(total_steps=40, update_every=4, ckpt_every=2,
                               ckpt_dir=str(root), fail_at_update=fail_at),
        learner, opt, tp, tm, lambda t: (xs[t], ys[t]), device="cpu")


@pytest.mark.parametrize("backend", ["compact", "compact_fused"])
def test_online_trainer_crash_and_resume_is_bitwise(backend, tmp_path):
    """A crash at update 7 of 10, a checkpoint every 2 updates: the resumed
    trainer ends with the uncrashed run's carry (the nested state
    included) and optimizer state, bit for bit."""
    cfg = SR.ScaledRTRLConfig(n=32, n_in=8, n_out=3, batch=3,
                              beta_capacity=0.5, sparsity=0.75)
    tp, tm = SR.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    made = []

    def make(attempt=0):
        made.append(_scaled_trainer(cfg, tp, tm, tmp_path / "a",
                                    fail_at=7 if attempt == 0 else -1,
                                    backend=backend))
        return made[-1]

    out = run_with_restart(make)
    ref = _scaled_trainer(cfg, tp, tm, tmp_path / "b", backend=backend)
    ref_out = ref.run()
    assert out["restarts"] == 1 and ref_out["updates"] == 10
    assert made[-1].update == ref.update == 10
    _trees_equal(made[-1].carry, ref.carry)
    _trees_equal(made[-1].opt_state, ref.opt_state)
    assert made[-1].row_stats() == ref.row_stats()


@pytest.mark.parametrize("L", [1, 2])
def test_row_stats_and_carry_bytes_read_the_nested_state(L):
    """`OnlineTrainer.row_stats` and `carry_nbytes` read a scaled carry's
    buffers under carry["state"] (without that they return None and price
    nothing live): the port's equal the reference trainer's on the same
    carry."""
    jcfg, cfg, jp, jm, tp, tm, xs, labels = _setup(
        n=16, n_in=5, B=2, L=L, capacity=0.5, sparsity=0.5, T=4)
    learner = make_learner(LearnerSpec(engine="scaled", cfg=cfg,
                                       col_compact=True, rewirable=True))
    carry = learner.init(tp, tm, (torch.from_numpy(xs[0]),
                                  torch.from_numpy(labels)), t_total=4.0)
    jlearner = JL.make_learner(JL.LearnerSpec(engine="scaled", cfg=jcfg,
                                              col_compact=True,
                                              rewirable=True))
    jcarry = jlearner.init(jp, jm, (jnp.asarray(xs[0]), jnp.asarray(labels)),
                           t_total=4.0)
    for t in range(4):
        carry, _ = learner.step(carry, torch.from_numpy(xs[t]),
                                torch.from_numpy(labels))
        jcarry, _ = jlearner.step(jcarry, jnp.asarray(xs[t]),
                                  jnp.asarray(labels))
    got = ON.OnlineTrainer.row_stats(types.SimpleNamespace(carry=carry))
    want = JON.OnlineTrainer.row_stats(types.SimpleNamespace(carry=jcarry))
    assert got is not None
    got.pop("layers", None)
    assert got == want
    nb = ON.OnlineTrainer.carry_nbytes(types.SimpleNamespace(carry=carry))
    jnb = JON.OnlineTrainer.carry_nbytes(types.SimpleNamespace(carry=jcarry))
    assert nb["live"] < nb["alloc"]
    assert nb["alloc"] - nb["live"] == jnb["alloc"] - jnb["live"]
    assert nb["col_density"] == jnb["col_density"] < 1.0
