"""The port's block-sparse influence update (kernel K2's plain version, its
wrapper, the block masks and the block accounting) held against the JAX
package on the same numpy inputs, the Pallas kernel run in interpret mode.

Tolerances: float32 results agree within 1e-5 of the largest magnitude of
the reference's (the same sums, associated differently by the two
libraries); block masks and `realized_block_savings` agree exactly.  The
J pattern is asymmetric at 8 x 8 block granularity wherever a jmask is
given: `build_block_masks` transposes the [l, k] pattern into the kernel's
[kb, lb] order, and a symmetric pattern would hide a missing transpose.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import influence as JIN, ops as JOPS, ref as JREF
from repro_torch.kernels import influence as IN, ops as OPS, ref as REF

REL = 1e-5


def _close(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale)


def _inputs(B, n, P, beta, seed):
    rng = np.random.default_rng(seed)
    hp = rng.random((B, n)).astype(np.float32)
    hp[rng.random((B, n)) < beta] = 0.0
    Jhat = rng.normal(size=(B, n, n)).astype(np.float32)
    M = rng.normal(size=(B, n, P)).astype(np.float32)
    M[rng.random((B, n)) < 0.3] = 0.0
    Mbar = rng.normal(size=(B, n, P)).astype(np.float32)
    return hp, Jhat, M, Mbar


def _asymmetric_jmask(n, omega, seed):
    """[l, k] pattern, live at 8 x 8 block granularity with density about
    1 - omega, forced asymmetric: block (0, last) live, (last, 0) dead."""
    nb = -(-n // 8)
    rng = np.random.default_rng(seed)
    blocks = rng.random((nb, nb)) > omega
    blocks[0, nb - 1], blocks[nb - 1, 0] = True, False
    blocks[np.arange(nb), np.arange(nb)] = True
    jm = np.kron(blocks, np.ones((8, 8)))[:n, :n]
    return (jm * (rng.random((n, n)) > omega / 2)).astype(np.float32)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


@pytest.mark.parametrize("B,n,P", [(1, 8, 128), (4, 32, 256), (3, 24, 130)])
@pytest.mark.parametrize("beta", [0.0, 0.5, 0.9])
def test_influence_update_matches_reference(B, n, P, beta):
    hp, Jhat, M, Mbar = _inputs(B, n, P, beta, seed=int(B * n + P + beta * 100))
    want = JOPS.influence_update(*map(jnp.asarray, (hp, Jhat, M, Mbar)))
    got = OPS.influence_update(*_t(hp, Jhat, M, Mbar))
    _close(got, want)
    _close(got, JREF.influence_ref(*map(jnp.asarray, (hp, Jhat, M, Mbar))))
    _close(REF.influence_ref(*_t(hp, Jhat, M, Mbar)), want)


@pytest.mark.parametrize("omega", [0.6, 0.9])
def test_influence_update_with_asymmetric_masks_matches_reference(omega):
    B, n, P = 2, 32, 256
    rng = np.random.default_rng(3)
    jmask = _asymmetric_jmask(n, omega, seed=4)
    assert not np.array_equal(jmask, jmask.T)
    col_mask = (rng.random(P) > omega).astype(np.float32)
    hp = rng.random((B, n)).astype(np.float32)
    Jhat = rng.normal(size=(B, n, n)).astype(np.float32) * jmask.T[None]
    M = rng.normal(size=(B, n, P)).astype(np.float32) * col_mask
    Mbar = rng.normal(size=(B, n, P)).astype(np.float32) * col_mask
    want = JOPS.influence_update(*map(jnp.asarray, (hp, Jhat, M, Mbar)),
                                 jmask=jnp.asarray(jmask),
                                 col_mask=jnp.asarray(col_mask))
    got = OPS.influence_update(*_t(hp, Jhat, M, Mbar, jmask, col_mask))
    _close(got, want)
    _close(got, JREF.influence_ref(*map(jnp.asarray, (hp, Jhat, M, Mbar))))
    # the pattern skips whole blocks here, so a transposed j_blocks would
    # drop live J blocks: the blocks must be the reference's, [kb, lb]
    _, _, _, _, _, _, _, jb = OPS.influence_operands(
        *_t(hp, Jhat, M, Mbar, jmask, col_mask))
    jjb = JIN.build_block_masks(jnp.asarray(hp), jnp.asarray(M),
                                jnp.asarray(col_mask), jnp.asarray(jmask),
                                bk=8, bl=8, bp=128)[3]
    np.testing.assert_array_equal(jb.numpy(), np.asarray(jjb))
    assert not np.array_equal(jb.numpy(), jb.numpy().T)


@pytest.mark.parametrize("B,n,P,masked", [(3, 24, 130, True),
                                          (2, 32, 256, False),
                                          (4, 20, 384, True)])
def test_block_masks_and_savings_equal_reference(B, n, P, masked):
    hp, Jhat, M, Mbar = _inputs(B, n, P, 0.5, seed=n + P)
    hp[0] = 0.0                                    # one example all dead
    jmask = col_mask = None
    if masked:
        jmask = _asymmetric_jmask(n, 0.7, seed=n)
        col_mask = (np.random.default_rng(P).random(P) > 0.6).astype(
            np.float32)
    np.testing.assert_array_equal(
        IN.block_any(torch.from_numpy(hp[:, :8 * (n // 8)]), 8, 1).numpy(),
        np.asarray(JIN.block_any(jnp.asarray(hp[:, :8 * (n // 8)]), 8, 1)))
    ops = OPS.influence_operands(*_t(hp, Jhat, M, Mbar, jmask, col_mask))
    jops = JOPS._pad_to(JOPS._pad_to(jnp.asarray(M), 8, 1), 128, 2)
    want = JIN.build_block_masks(
        JOPS._pad_to(jnp.asarray(hp), 8, 1), jops,
        None if col_mask is None else jnp.asarray(col_mask),
        None if jmask is None else jnp.asarray(jmask), bk=8, bl=8, bp=128)
    for got, w in zip(ops[4:], want):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    jsav = JOPS.realized_block_savings(
        jnp.asarray(hp), jnp.asarray(M),
        None if jmask is None else jnp.asarray(jmask),
        None if col_mask is None else jnp.asarray(col_mask))
    sav = OPS.realized_block_savings(*_t(hp, M, jmask, col_mask))
    assert sav == jsav
    # the block count the wrapper reports is the savings times all blocks
    total = B * ops[4].shape[1] * ops[5].shape[1] * ops[6].shape[0]
    count = torch.zeros(1, dtype=torch.int64)
    IN.influence_update(*ops[:4], row_mask=ops[4], prev_mask=ops[5],
                        col_mask=ops[6], jmask=ops[7], block_count=count)
    assert int(count) == round(sav * total)
    assert abs(sav * total - round(sav * total)) < 1e-6


def test_plain_version_equals_pallas_kernel_on_arbitrary_masks():
    """With masks NOT derived from the operands (dead blocks holding
    nonzeros), the plain version still computes what the kernel does."""
    B, n, P = 3, 24, 256
    rng = np.random.default_rng(7)
    hp, Jhat, M, Mbar = _inputs(B, n, P, 0.0, seed=8)
    nb, npb = n // 8, P // 128
    row = (rng.random((B, nb)) > 0.4).astype(np.int32)
    prev = (rng.random((B, nb)) > 0.4).astype(np.int32)
    cols = np.array([1, 0], np.int32)
    jm = (rng.random((nb, nb)) > 0.4).astype(np.int32)
    want = JIN.influence_update_pallas(
        *map(jnp.asarray, (hp, Jhat, M, Mbar)), row_mask=jnp.asarray(row),
        prev_mask=jnp.asarray(prev), col_mask=jnp.asarray(cols),
        jmask=jnp.asarray(jm), interpret=True)
    got = IN.influence_reference(*_t(hp, Jhat, M, Mbar), row_mask=_t(row)[0],
                                 prev_mask=_t(prev)[0], col_mask=_t(cols)[0],
                                 jmask=_t(jm)[0])
    _close(got, want)
    dead = ~(np.repeat(row, 8, 1)[:, :, None].astype(bool)
             & np.repeat(cols, 128).astype(bool))
    assert (got.numpy()[dead] == 0).all() and npb == 2


def test_ref_grads_oracle_and_cpu_wrapper():
    rng = np.random.default_rng(1)
    cbar = rng.normal(size=(3, 16)).astype(np.float32)
    M = rng.normal(size=(3, 16, 256)).astype(np.float32)
    _close(REF.influence_grads_ref(*_t(cbar, M)),
           JREF.influence_grads_ref(jnp.asarray(cbar), jnp.asarray(M)))
    hp, Jhat, M, Mbar = _inputs(2, 16, 128, 0.5, seed=2)
    before = IN.influence_update.launches
    ops = OPS.influence_operands(*_t(hp, Jhat, M, Mbar))
    out = IN.influence_update(*ops[:4], row_mask=ops[4], prev_mask=ops[5],
                              col_mask=ops[6], jmask=ops[7])
    assert IN.influence_update.launches == before     # CPU: no launch
    assert out.dtype == torch.float32 and out.shape == (2, 16, 128)
    _close(out, JREF.influence_ref(*map(jnp.asarray, (hp, Jhat, M, Mbar))))


@pytest.mark.parametrize("shape", [(4, 8), (1, 16), (3, 1, 5), (2, 0, 3), (7,)])
def test_contiguous_strides_are_torchs(shape):
    from repro_torch.kernels import _build
    assert _build.contiguous_strides(shape) == torch.empty(shape).stride()


def test_kernel_call_checks_packs_and_raises(monkeypatch):
    """`KernelCall` (the K2/K3 launch path) on CPU tensors, with the device
    and stream lookups stubbed: one comparison per operand, the reasons
    raised where one differs, the launch arguments packed as 64-bit ints
    (pointers, dims, stream), a failed launch raised."""
    import struct
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "_get_device", lambda: None)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 77)
    cpu = torch.device("cpu")
    calls = []

    class Lib:
        @staticmethod
        def repro_error_string(err):
            return b"bad launch"

    def fn(packed):
        calls.append(struct.unpack(f"{len(packed) // 8}Q", packed))
        return int(calls[-1][0] == 0)       # fails when the first pointer is 0
    f32, i32 = torch.float32, torch.int32
    call = _build.KernelCall("k", cpu, [("x", f32, (f32,), (4, 8)),
                                        ("m", i32, (i32,), (2,))],
                             Lib, fn, (4, 8), n_ptrs=3)
    x, m = torch.zeros((4, 8)), torch.zeros(2, dtype=i32)
    assert call.matches((x, m))
    call.check((x, m))
    assert not call.matches((x.T.contiguous().T, m))
    with pytest.raises(ValueError, match="x must be contiguous"):
        call.check((x.T.contiguous().T, m))
    with pytest.raises(TypeError, match="m must be torch.int32"):
        call.check((x, m.long()))
    with pytest.raises(ValueError, match=r"m has shape \(3,\)"):
        call.check((x, torch.zeros(3, dtype=i32)))
    odd = torch.zeros((8, 1)).T                     # contiguous, odd unit stride
    call1 = _build.KernelCall("k", cpu, [("y", f32, (f32,), (1, 8))], Lib, fn,
                              (), n_ptrs=1)
    assert not call1.matches((odd,))
    call1.check((odd,))
    call.launch(11, 22, 0)
    assert calls[-1] == (11, 22, 0, 4, 8, 77)
    with pytest.raises(RuntimeError, match="k: kernel launch failed: error 1: "
                                           "bad launch"):
        call.launch(0, 22, 33)


# ---------------------------------------------------------------------------
# The column and J block masks, built once for a run (the pallas learner)
# ---------------------------------------------------------------------------

def _spiral(masked, B=2, seed=0):
    """The spiral EGRU's JAX-drawn params and (sparsity 0.8) masks, as numpy,
    with both packages' configs."""
    import jax
    from repro.core import cells as JC, sparse_rtrl as JSP
    from repro_torch.core import cells as C
    jcfg = JC.EGRUConfig(n_hidden=16, n_in=2, n_out=2, batch_size=B)
    cfg = C.EGRUConfig(n_hidden=16, n_in=2, n_out=2, batch_size=B)
    params = JC.init_params(jcfg, jax.random.key(seed))
    masks = None
    if masked:
        masks = JSP.make_masks(jcfg, jax.random.key(seed + 1), 0.8)
        params = JSP.apply_masks(params, masks)
        masks = jax.tree.map(np.asarray, masks)
    return jcfg, cfg, jax.tree.map(np.asarray, params), masks


def _carry_masks(cfg, masks, carry):
    """(n, P, jmask, col_mask) of the pallas learner's carry: the flat axis
    at full width or column-compact, as `SparseLearner.init` builds them."""
    from repro_torch.core import sparse_rtrl as SP
    from repro_torch.weights import masks_from_numpy
    tmasks = None if masks is None else masks_from_numpy(masks, "cpu")
    layout = SP.flat_layout(cfg)
    if carry == "compact":
        cl = SP.col_layout(layout, tmasks, device="cpu")
        P, colm = cl.Pc_pad, cl.live
    else:
        P, colm = layout.P_pad, SP.flat_col_mask(layout, tmasks, device="cpu")
    return cfg.n_hidden, P, SP.flat_jmask(cfg, tmasks), colm


def _carry_inputs(n, P, jmask, col_mask, B=2, seed=5):
    """Random hp, J-hat, M, M-bar honouring the masks (M and M-bar zero in
    dead columns, J-hat zero outside the J pattern), as numpy."""
    rng = np.random.default_rng(seed)
    hp = rng.random((B, n)).astype(np.float32)
    hp[rng.random((B, n)) < 0.3] = 0.0
    Jhat = rng.normal(size=(B, n, n)).astype(np.float32)
    M = rng.normal(size=(B, n, P)).astype(np.float32)
    M[rng.random((B, n)) < 0.3] = 0.0
    Mbar = rng.normal(size=(B, n, P)).astype(np.float32)
    cm = col_mask.numpy()
    M, Mbar = M * cm, Mbar * cm
    if jmask is not None:
        Jhat *= jmask.numpy().T[None]
    return hp, Jhat, M, Mbar


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("carry", ["full", "compact"])
def test_prebuilt_constant_masks_equal_build_block_masks(masked, carry):
    _, cfg, _, masks = _spiral(masked)
    n, P, jm, cm = _carry_masks(cfg, masks, carry)
    kmasks = OPS.constant_block_masks(n, P, jm, cm, device=torch.device("cpu"))
    hp, Jhat, M, Mbar = _carry_inputs(n, P, jm, cm)
    ops = OPS.influence_operands(*_t(hp, Jhat, M, Mbar), jm, cm)
    ops_pre = OPS.influence_operands(*_t(hp, Jhat, M, Mbar), jm, cm,
                                     block_masks=kmasks)
    for got, want in zip(ops_pre, ops):
        assert got.dtype == want.dtype and torch.equal(got, want)
    want = JIN.build_block_masks(
        JOPS._pad_to(jnp.asarray(hp), 8, 1),
        JOPS._pad_to(JOPS._pad_to(jnp.asarray(M), 8, 1), 128, 2),
        jnp.asarray(cm.numpy()),
        None if jm is None else jnp.asarray(jm.numpy()), bk=8, bl=8, bp=128)
    np.testing.assert_array_equal(kmasks[0].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(kmasks[1].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("carry", ["full", "compact"])
def test_influence_update_with_prebuilt_masks_matches_reference(masked, carry):
    _, cfg, _, masks = _spiral(masked)
    n, P, jm, cm = _carry_masks(cfg, masks, carry)
    kmasks = OPS.constant_block_masks(n, P, jm, cm, device=torch.device("cpu"))
    hp, Jhat, M, Mbar = _carry_inputs(n, P, jm, cm)
    got = OPS.influence_update(*_t(hp, Jhat, M, Mbar), jm, cm,
                               block_masks=kmasks)
    want = JOPS.influence_update(
        *map(jnp.asarray, (hp, Jhat, M, Mbar)),
        jmask=None if jm is None else jnp.asarray(jm.numpy()),
        col_mask=jnp.asarray(cm.numpy()))
    _close(got, want)
    _close(got, JREF.influence_ref(*map(jnp.asarray, (hp, Jhat, M, Mbar))))


@pytest.mark.parametrize("col_compact", [None, False])
def test_pallas_learner_first_window_matches_reference(col_compact,
                                                       monkeypatch):
    """The pallas learner builds its column and J block masks once, at
    init, and its first window's loss, gradients and carry still equal the
    JAX package's; no step rebuilds the constant masks."""
    import jax
    from repro.core import learner as JL
    from repro.runtime import online as JON
    from repro_torch.core.learner import LearnerSpec, make_learner
    from repro_torch.runtime import online as ON
    from repro_torch.weights import (masks_from_numpy, params_from_numpy,
                                     to_numpy)
    B, k = 4, 8
    jcfg, cfg, params, masks = _spiral(True, B=B)
    rng = np.random.default_rng(0)
    xs = (rng.normal(size=(k, B, 2))
          * np.linspace(0.5, 2.5, B)[None, :, None]).astype(np.float32)
    ys = np.broadcast_to(rng.integers(0, 2, B).astype(np.int32), (k, B)).copy()
    jl = JL.make_learner(JL.LearnerSpec(engine="sparse", cfg=jcfg,
                                        backend="pallas",
                                        col_compact=col_compact))
    jc = jl.init(jax.tree.map(jnp.asarray, params),
                 jax.tree.map(jnp.asarray, masks),
                 (jnp.asarray(xs[0]), jnp.asarray(ys[0])), t_total=8.0)
    jc, jloss, jgrads, _ = JON.stream_grads(jl, jc, jnp.asarray(xs),
                                            jnp.asarray(ys))
    tl = make_learner(LearnerSpec(engine="sparse", cfg=cfg, backend="pallas",
                                  col_compact=col_compact))
    tc = tl.init(params_from_numpy(params, "cpu"),
                 masks_from_numpy(masks, "cpu"),
                 (torch.from_numpy(xs[0]), torch.from_numpy(ys[0])),
                 t_total=8.0)
    n, P = cfg.n_hidden, tc["M"].shape[-1]
    colm = tl._cl.live if tl._cl is not None else tl._colm
    assert all(torch.equal(a, b) for a, b in zip(
        tl._kmasks, IN.build_block_masks(
            torch.zeros((B, n)), torch.zeros((B, n, P)), colm, tl._jm)[2:]))
    rebuilt = []
    monkeypatch.setattr(IN, "constant_block_masks",
                        lambda *a, **kw: rebuilt.append(a))
    tc, tloss, tgrads, _ = ON.stream_grads(tl, tc, torch.from_numpy(xs),
                                           torch.from_numpy(ys))
    assert rebuilt == []
    assert float(tloss) == pytest.approx(float(jloss), rel=REL)
    got = jax.tree.leaves(to_numpy(tgrads))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jgrads))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    _close(tc["M"], jc["M"])
