"""The port's event-driven matmul (kernel K3's front end, wrapper and plain
version: `repro_torch.kernels.ops.event_matmul`,
`repro_torch.kernels.event_matmul`) held against the JAX package on the
same numpy inputs, the Pallas kernel run in interpret mode.

Tolerances: the reference's own for the front end (`tests/test_kernels.py`,
`test_event_matmul_matches_ref`: 1e-5 in f32, 2e-2 in bf16); the plain
version against the Pallas kernel on given masks within 1e-5 of the
largest magnitude (f32); block masks and counts exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS, ref as JREF
from repro.kernels.event_matmul import event_matmul_pallas
from repro_torch.kernels import event_matmul as EM, ops as OPS, ref as REF

DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(B, n, m, seed):
    rng = np.random.default_rng(seed)
    a = (rng.random((B, n)) > 0.7).astype(np.float32)
    R = rng.standard_normal((n, m)).astype(np.float32)
    return a, R


def _both(arr, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return torch.from_numpy(arr).to(tdt), jnp.asarray(arr, jdt)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("B,n,m", [(2, 16, 128), (4, 64, 256), (1, 40, 130)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_event_matmul_matches_reference(B, n, m, dtype):
    a, R = _inputs(B, n, m, seed=B + n + m)
    (ta, ja), (tR, jR) = _both(a, dtype), _both(R, dtype)
    tol = DTYPES[dtype][2]
    y = OPS.event_matmul(ta, tR)
    assert y.dtype == tR.dtype and y.shape == (B, m)
    np.testing.assert_allclose(_f32(y), _f32(JOPS.event_matmul(ja, jR)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(y), _f32(JREF.event_matmul_ref(ja, jR)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(REF.event_matmul_ref(ta, tR)),
                               _f32(JREF.event_matmul_ref(ja, jR)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,n,m", [(3, 24, 256), (2, 40, 130)])
def test_event_matmul_with_rmask_matches_reference(B, n, m):
    """A given [n, m] parameter mask skips whole (8 x 128) blocks of R,
    and only those: R itself is not masked, as in the reference."""
    a, R = _inputs(B, n, m, seed=n)
    rng = np.random.default_rng(m)
    blocks = rng.random((-(-n // 8), -(-m // 128))) > 0.5
    blocks[0, 0], blocks[-1, -1] = False, True
    rmask = np.kron(blocks, np.ones((8, 128)))[:n, :m].astype(np.float32)
    rmask *= rng.random((n, m)) > 0.3
    y = OPS.event_matmul(*(torch.from_numpy(x) for x in (a, R, rmask)))
    want = JOPS.event_matmul(*(jnp.asarray(x) for x in (a, R, rmask)))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    _, _, act, rm = OPS.event_matmul_operands(
        *(torch.from_numpy(x) for x in (a, R, rmask)))
    assert rm.dtype == act.dtype == torch.int32
    np.testing.assert_array_equal(rm.numpy(), blocks.astype(np.int32))


def test_plain_version_equals_pallas_kernel_on_arbitrary_masks():
    """With masks NOT derived from the operands (skipped blocks of a that
    hold events, skipped blocks of R that hold weights), the plain version
    still computes what the kernel does, and counts its blocks."""
    B, n, m = 3, 32, 256
    rng = np.random.default_rng(7)
    a = rng.standard_normal((B, n)).astype(np.float32)
    R = rng.standard_normal((n, m)).astype(np.float32)
    act = (rng.random((B, n // 8)) > 0.4).astype(np.int32)
    rm = (rng.random((n // 8, m // 128)) > 0.4).astype(np.int32)
    act[0] = 0                                       # an example with no events
    want = event_matmul_pallas(*map(jnp.asarray, (a, R)), act_mask=jnp.asarray(act),
                               rmask=jnp.asarray(rm), interpret=True)
    count = torch.zeros(1, dtype=torch.int64)
    before = EM.event_matmul.launches
    got = EM.event_matmul(*map(torch.from_numpy, (a, R)),
                          act_mask=torch.from_numpy(act), rmask=torch.from_numpy(rm),
                          block_count=count)
    assert EM.event_matmul.launches == before          # CPU: no launch
    scale = max(float(np.abs(np.asarray(want)).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * scale)
    assert (got.numpy()[0] == 0).all()
    assert int(count) == int((act[:, :, None] * rm[None]).sum())


def test_all_zero_activity_skips_every_block():
    a = torch.zeros((2, 16))
    R = torch.randn((16, 256), generator=torch.Generator().manual_seed(0))
    a_p, R_p, act, rm = OPS.event_matmul_operands(a, R)
    assert int(act.sum()) == 0 and int(EM.executed_blocks(act, rm)) == 0
    count = torch.zeros(1, dtype=torch.int64)
    y = EM.event_matmul(a_p, R_p, act_mask=act, rmask=rm, block_count=count)
    assert int(count) == 0 and bool((y == 0).all())


def test_operand_check_shared_by_the_k3_and_k4_wrappers():
    """What the CUDA wrappers refuse before handing pointers to a kernel
    (run here on CPU tensors: the check itself needs no card)."""
    from repro_torch.kernels import _build
    cpu = torch.device("cpu")
    t = torch.zeros((4, 8))
    _build.check_operand("k", "t", t, (torch.float32,), (4, 8), cpu)
    for bad, err, match in (
            (t.bfloat16(), TypeError, "t must be torch.float32, got torch.bfloat16"),
            (t[:, :4], ValueError, r"shape \(4, 4\), expected \(4, 8\)"),
            (torch.zeros((8, 4)).T, ValueError, "contiguous"),
            (t.to("meta"), ValueError, "t is on meta, expected cpu")):
        with pytest.raises(err, match=match):
            _build.check_operand("k", "t", bad, (torch.float32,), (4, 8), cpu)
