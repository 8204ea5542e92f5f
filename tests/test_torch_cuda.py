"""The port on the card: the CUDA kernels against their plain versions, and
the main path's learners on CUDA against the same learners on the CPU.

Every test here is marked `cuda` and skips where there is no card.  This
file imports neither JAX nor the JAX package, so it runs on a machine
without them (pytest's --noconftest skips tests/conftest.py, which imports
JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: float32 within 1e-5 of the largest
magnitude; bf16 within one bf16 rounding step (2^-7 relative) more.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import compact_fused as CF
from repro_torch.kernels import influence as IN, ops as OPS

F32_REL = 1e-5
BF16_STEP = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _operands(device, dtype, B, K, n, Pc, seed=0):
    """Ragged operands: one full example, one one-row example, one with
    count_prev = 0, the rest random; -1 sentinels past each count."""
    rng = np.random.default_rng(seed)
    cn = rng.integers(1, K + 1, B)
    cp = rng.integers(1, K + 1, B)
    cn[0], cp[0], cn[1], cp[2] = K, K, 1, 0
    idx_new = np.full((B, K), -1, np.int32)
    idx_prev = np.full((B, K), -1, np.int32)
    for b in range(B):
        idx_new[b, :cn[b]] = np.sort(rng.choice(n, cn[b], replace=False))
        idx_prev[b, :cp[b]] = np.sort(rng.choice(n, cp[b], replace=False))
    vals = rng.normal(size=(B, K, Pc)).astype(np.float32)
    vals[idx_prev < 0] = 0.0
    hp = np.abs(rng.normal(size=(B, K))).astype(np.float32)
    hp[idx_new < 0] = 0.0
    ops = [rng.normal(size=(B, n, n)).astype(np.float32), vals,
           rng.normal(size=(B, K, Pc)).astype(np.float32), hp, idx_new,
           idx_prev, cn.astype(np.int32), cp.astype(np.int32)]
    ops = [torch.from_numpy(a).to(device) for a in ops]
    ops[1] = ops[1].to(dtype)
    return ops


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,n,Pc", [(3, 16, 40, 384), (32, 16, 16, 256),
                                      (3, 256, 256, 1024), (4, 20, 20, 200)])
def test_kernel_matches_plain_version(cuda, dtype, B, K, n, Pc):
    ops = _operands(cuda, dtype, B, K, n, Pc)
    before = CF.fused_update.launches
    out = CF.fused_update(*ops)
    torch.cuda.synchronize()
    assert CF.fused_update.launches == before + 1
    ref = CF.fused_reference(*ops)
    assert out.dtype == dtype and out.shape == ref.shape
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    scale = max(float(r.abs().max()), 1.0)
    if dtype == torch.float32:
        assert float(err.max()) <= F32_REL * scale
    else:
        assert bool((err <= BF16_STEP * r.abs() + F32_REL * scale).all())
    rows = torch.arange(K, device=cuda)[None, :]
    dead = rows >= ops[6][:, None]
    assert bool((o[dead] == 0).all())


@pytest.mark.cuda
def test_kernel_rejects_bad_operands(cuda):
    ops = _operands(cuda, torch.float32, 3, 16, 40, 384)
    bad = list(ops)
    bad[4] = bad[4].long()
    with pytest.raises(TypeError, match="idx_new"):
        CF.fused_update(*bad)
    bad = list(ops)
    bad[2] = bad[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        CF.fused_update(*bad)


def _k2_operands(B, n, P, *, beta, dead_example, masked, zero_M, seed=0):
    """Unpadded K2 operands honouring the contract: M and M-bar zero in
    dead columns, J-hat zero outside the asymmetric J pattern."""
    rng = np.random.default_rng(seed)
    hp = rng.random((B, n)).astype(np.float32)
    hp[rng.random((B, n)) < beta] = 0.0
    if dead_example:
        hp[-1] = 0.0
    jmask = col_mask = None
    Jhat = rng.normal(size=(B, n, n)).astype(np.float32)
    M = rng.normal(size=(B, n, P)).astype(np.float32)
    M[rng.random((B, n)) < beta] = 0.0
    Mbar = rng.normal(size=(B, n, P)).astype(np.float32)
    if masked:
        nb = -(-n // 8)
        blocks = rng.random((nb, nb)) > 0.5
        blocks[0, nb - 1], blocks[nb - 1, 0] = True, False
        jmask = np.kron(blocks, np.ones((8, 8)))[:n, :n].astype(np.float32)
        col_mask = (rng.random(P) > 0.5).astype(np.float32)
        Jhat *= jmask.T[None]
        M *= col_mask
        Mbar *= col_mask
    if zero_M:
        M[:] = 0.0
    return hp, Jhat, M, Mbar, jmask, col_mask


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,P,beta,dead_example,masked,zero_M", [
    (32, 16, 1024, 0.15, False, True, False),   # (a) full width
    (32, 16, 256, 0.15, False, True, False),    # (a) column-compact
    (3, 20, 130, 0.3, True, True, False),       # (c) padding, a dead example
    (3, 20, 130, 0.0, False, False, True),      # (c) first step, no masks
])
def test_influence_kernel_matches_plain_version(cuda, B, n, P, beta,
                                                dead_example, masked, zero_M):
    arrays = _k2_operands(B, n, P, beta=beta, dead_example=dead_example,
                          masked=masked, zero_M=zero_M)
    t = [None if a is None else torch.from_numpy(a).to(cuda) for a in arrays]
    ops = OPS.influence_operands(*t)
    masks = dict(row_mask=ops[4], prev_mask=ops[5], col_mask=ops[6],
                 jmask=ops[7])
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    before = IN.influence_update.launches
    out = IN.influence_update(*ops[:4], **masks, block_count=count)
    torch.cuda.synchronize()
    assert IN.influence_update.launches == before + 1
    ref = IN.influence_reference(*ops[:4], **masks)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= F32_REL * scale
    live = (ops[4] != 0).repeat_interleave(8, 1)[:, :, None] & \
        (ops[6] != 0).repeat_interleave(128)
    assert bool((out[~live] == 0).all())
    sav = OPS.realized_block_savings(arrays[0], arrays[2], arrays[4],
                                     arrays[5])
    total = B * ops[4].shape[1] * ops[5].shape[1] * ops[6].shape[0]
    assert int(count) == round(sav * total)
    got = OPS.influence_update(*t)                 # the cropped front end
    assert tuple(got.shape) == (B, n, P)
    assert float((got - ref[:, :n, :P]).abs().max()) <= F32_REL * scale


@pytest.mark.cuda
def test_influence_kernel_rejects_bad_operands(cuda):
    arrays = _k2_operands(2, 16, 256, beta=0.2, dead_example=False,
                          masked=True, zero_M=False)
    t = [None if a is None else torch.from_numpy(a).to(cuda) for a in arrays]
    ops = list(OPS.influence_operands(*t))
    masks = dict(row_mask=ops[4], prev_mask=ops[5], col_mask=ops[6],
                 jmask=ops[7])
    with pytest.raises(TypeError, match="M must be torch.float32"):
        IN.influence_update(ops[0], ops[1], ops[2].bfloat16(), ops[3], **masks)
    with pytest.raises(TypeError, match="Mbar must be torch.float32"):
        IN.influence_update(*ops[:3], ops[3].double(), **masks)
    with pytest.raises(TypeError, match="jmask"):
        IN.influence_update(*ops[:4], **{**masks, "jmask": ops[7].long()})
    bad = ops[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        IN.influence_update(ops[0], bad, *ops[2:4], **masks)
    with pytest.raises(TypeError, match="block_count"):
        IN.influence_update(*ops[:4], **masks,
                            block_count=torch.zeros(1, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["compact", "compact_fused", "pallas",
                                     "dense"])
def test_first_window_on_cuda_matches_cpu(cuda, backend):
    from repro_torch.launch import train as TRAIN
    from repro_torch.runtime import online as ON
    from repro_torch.tree import tree_leaves

    def window(device):
        argv = ["--arch", "egru-spiral", "--online", "--rtrl-backend",
                backend, "--sparsity", "0.8", "--device", device]
        run = TRAIN.build_online(TRAIN.parse_args(argv))
        xs, ys = zip(*(run["stream"](t) for t in range(8)))
        xs = torch.from_numpy(np.stack(xs)).to(run["device"])
        ys = torch.from_numpy(np.stack(ys)).to(run["device"])
        carry = run["learner"].init(run["params"], run["masks"],
                                    (xs[0], ys[0]), t_total=8.0)
        _, loss, grads, _ = ON.stream_grads(run["learner"], carry, xs, ys)
        return float(loss), tree_leaves(grads)

    before = CF.fused_update.launches, IN.influence_update.launches
    lg, gg = window("cuda")
    launched = (CF.fused_update.launches - before[0],
                IN.influence_update.launches - before[1])
    assert launched == ((8 if backend == "compact_fused" else 0),
                        (8 if backend == "pallas" else 0))
    lc, gc = window("cpu")
    assert lg == pytest.approx(lc, rel=F32_REL)
    for a, b in zip(gg, gc):
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a.cpu() - b).abs().max()) <= F32_REL * scale
