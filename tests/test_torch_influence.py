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
