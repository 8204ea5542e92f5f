"""The port on the card: the CUDA kernel against its plain version, and the
main path's learner on CUDA against the same learner on the CPU.

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


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["compact", "compact_fused"])
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

    before = CF.fused_update.launches
    lg, gg = window("cuda")
    launched = CF.fused_update.launches - before
    assert launched == (8 if backend == "compact_fused" else 0)
    lc, gc = window("cpu")
    assert lg == pytest.approx(lc, rel=F32_REL)
    for a, b in zip(gg, gc):
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a.cpu() - b).abs().max()) <= F32_REL * scale
