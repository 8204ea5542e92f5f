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

from repro_torch.kernels import compact_fused as CF, event_matmul as EM
from repro_torch.kernels import influence as IN, ops as OPS, wkv as WK

F32_REL = 1e-5
BF16_STEP = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _operands(device, dtype, B, K, n, Pc, seed=0, counts=None):
    """Ragged operands: one full example, one one-row example, one with
    count_prev = 0, the rest random; or the given (count_new, count_prev);
    -1 sentinels past each count."""
    rng = np.random.default_rng(seed)
    if counts is None:
        cn = rng.integers(1, K + 1, B)
        cp = rng.integers(1, K + 1, B)
        cn[0], cp[0], cn[1], cp[2] = K, K, 1, 0
    else:
        cn, cp = (np.array(c) for c in counts)
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


def _check_fused(ops, dtype):
    """One kernel launch on `ops` against the plain version: within the
    tolerance, rows past count_new exactly 0."""
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
    K = ops[1].shape[1]
    rows = torch.arange(K, device=out.device)[None, :]
    dead = rows >= ops[6][:, None]
    assert bool((o[dead] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,n,Pc", [(3, 16, 40, 384), (32, 16, 16, 256),
                                      (3, 256, 256, 1024), (4, 20, 20, 200),
                                      (3, 72, 80, 264),       # a partial 2nd row tile
                                      (3, 512, 512, 384),     # 16 ring chunks
                                      (8, 256, 256, 4352)])   # 1,088 CTAs
def test_kernel_matches_plain_version(cuda, dtype, B, K, n, Pc):
    _check_fused(_operands(cuda, dtype, B, K, n, Pc), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts", [
    # count_new 8 / 9: a dead warp and a one-row warp in a live tile; 72 / 65:
    # the partial 2nd tile full and one row; count_prev at the ring chunks'
    # edges (31, 32, 33) and past two chunks (65)
    ([8, 9, 72, 65], [31, 32, 33, 65]),
    # an example with no live row (its first tile dead), one with no
    # previous row
    ([9, 0, 1, 64], [65, 32, 0, 31])])
def test_kernel_at_tile_and_ring_edges(cuda, dtype, counts):
    _check_fused(_operands(cuda, dtype, 4, 72, 80, 256, counts=counts), dtype)


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
    bad = list(ops)
    bad[1] = torch.zeros(bad[1].numel() + 1, device=cuda)[1:].view(bad[1].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        CF.fused_update(*bad)
    odd = _operands(cuda, torch.float32, 3, 16, 40, 196)
    with pytest.raises(ValueError, match=r"Pc % 8 == 0"):
        CF.fused_update(*odd)


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


def _k2_edge_operands(case, seed=5):
    """Unpadded K2 operands at the edges of the kernel's tiles (a CTA holds
    up to 8 row blocks = 64 rows and 128 columns), and the executed-block
    count they must give where it is known by construction (else None)."""
    rng = np.random.default_rng(seed)
    B, n, P = {"n72": (3, 72, 256), "dead_group": (2, 256, 256),
               "one_row_block": (2, 64, 256), "dead_last_tile": (2, 40, 640),
               "large_grid": (4, 256, 5120)}[case]
    hp = (rng.random((B, n)) + 0.1).astype(np.float32)
    Jhat = rng.normal(size=(B, n, n)).astype(np.float32)
    M = rng.normal(size=(B, n, P)).astype(np.float32)
    Mbar = rng.normal(size=(B, n, P)).astype(np.float32)
    jmask = col_mask = expect = None
    if case == "n72":                       # one full group, one of 1 block
        hp[rng.random((B, n)) < 0.3] = 0.0
        hp[0, 64:] = 0.0                    # the partial group's block dead
        hp[1, 8:16] = 0.0
        M[rng.random((B, n)) < 0.3] = 0.0
    elif case == "dead_group":              # rows 64..127: a whole group dead
        hp[:, 64:128] = 0.0
        hp[1, 200:208] = 0.0
    elif case == "one_row_block":
        # l-blocks 3 and 5 alone are live; J pattern [kb, lb]: l-block 3
        # only for row block 5, l-block 5 for every row block
        M[:] = 0.0
        M[:, 24:32] = rng.normal(size=(B, 8, P))
        M[:, 40:48] = rng.normal(size=(B, 8, P))
        blocks = np.zeros((8, 8), bool)             # [kb, lb]
        blocks[5, 3] = True
        blocks[:, 5] = True
        jmask = np.kron(blocks.T, np.ones((8, 8))).astype(np.float32)
        Jhat *= jmask.T[None]
        expect = B * (1 + 8) * (P // 128)
    elif case == "large_grid":              # 1280 CTAs: several waves
        hp[rng.random((B, n)) < 0.5] = 0.0
        hp[1, :] = 0.0
        M[rng.random((B, n)) < 0.5] = 0.0
        col_mask = (rng.random(P) > 0.5).astype(np.float32)
        M *= col_mask
        Mbar *= col_mask
    else:                                   # the last column tile dead
        col_mask = (rng.random(P) > 0.3).astype(np.float32)
        col_mask[512:] = 0.0
        col_mask[:128] = 1.0
        M *= col_mask
        Mbar *= col_mask
    return (hp, Jhat, M, Mbar, jmask, col_mask), expect


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n72", "dead_group", "one_row_block",
                                  "dead_last_tile", "large_grid"])
def test_influence_kernel_at_tile_edges(cuda, case):
    arrays, expect = _k2_edge_operands(case)
    t = [None if a is None else torch.from_numpy(a).to(cuda) for a in arrays]
    ops = OPS.influence_operands(*t)
    masks = dict(row_mask=ops[4], prev_mask=ops[5], col_mask=ops[6],
                 jmask=ops[7])
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    out = IN.influence_update(*ops[:4], **masks, block_count=count)
    torch.cuda.synchronize()
    ref = IN.influence_reference(*ops[:4], **masks)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= F32_REL * scale
    live = (ops[4] != 0).repeat_interleave(8, 1)[:, :, None] & \
        (ops[6] != 0).repeat_interleave(128)
    assert bool((out[~live] == 0).all())
    B = ops[2].shape[0]
    total = B * ops[4].shape[1] * ops[5].shape[1] * ops[6].shape[0]
    sav = OPS.realized_block_savings(arrays[0], arrays[2], arrays[4],
                                     arrays[5])
    assert int(count) == round(sav * total)
    if expect is not None:
        assert int(count) == expect


@pytest.mark.cuda
def test_influence_kernel_with_prebuilt_masks_equals_rebuilt(cuda):
    arrays, _ = _k2_edge_operands("dead_last_tile")
    t = [None if a is None else torch.from_numpy(a).to(cuda) for a in arrays]
    n, P = arrays[2].shape[1:]
    kmasks = OPS.constant_block_masks(n, P, t[4], t[5], device=cuda)
    got = OPS.influence_update(*t, block_masks=kmasks)
    want = OPS.influence_update(*t)
    assert torch.equal(got, want)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("solo_first", [False, True])
def test_kernel_folds_vmapped_slots_into_one_launch(cuda, dtype, solo_first):
    """K1 under torch.func.vmap (the stream fleet's slots): one launch for
    every slot, each slot within the bar of the plain version on its own
    operands, its dead rows exactly 0 — also right after an unbatched call
    of a slot's shapes, which the vmapped call's shapes match."""
    slots = [_operands(cuda, dtype, 4, 16, 40, 384, seed=s) for s in range(3)]
    stacked = [torch.stack([ops[i] for ops in slots]) for i in range(8)]
    if solo_first:
        CF.fused_update(*slots[0])
    before = CF.fused_update.launches
    out = torch.func.vmap(CF.fused_update)(*stacked)
    torch.cuda.synchronize()
    assert CF.fused_update.launches == before + 1
    assert out.shape == stacked[1].shape and out.dtype == dtype
    for s, ops in enumerate(slots):
        ref = CF.fused_reference(*ops).float()
        o = out[s].float()
        err = (o - ref).abs()
        scale = max(float(ref.abs().max()), 1.0)
        if dtype == torch.float32:
            assert float(err.max()) <= F32_REL * scale
        else:
            assert bool((err <= BF16_STEP * ref.abs() + F32_REL * scale).all())
        dead = torch.arange(16, device=cuda)[None, :] >= ops[6][:, None]
        assert bool((o[dead] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("solo_first", [False, True])
def test_influence_kernel_folds_vmapped_slots_into_one_launch(cuda,
                                                              solo_first):
    """K2 under torch.func.vmap: one launch for every slot, the column and
    J block masks shared, each slot within the bar of the plain version,
    and the shared counter adding every slot's executed blocks — also right
    after an unbatched call of a slot's shapes."""
    slots = []
    for s in range(3):
        a = list(_k2_operands(4, 20, 130, beta=0.3, dead_example=s == 1,
                              masked=True, zero_M=False, seed=0))
        rng = np.random.default_rng(10 + s)     # slot-own values, one pattern
        a[0] = np.where(a[0] != 0, rng.random(a[0].shape), 0.0).astype(
            np.float32)
        a[2] = (a[2] * rng.normal(size=a[2].shape)).astype(np.float32)
        slots.append(a)
    t = [[None if x is None else torch.from_numpy(x).to(cuda) for x in a]
         for a in slots]
    ops = [OPS.influence_operands(*ts) for ts in t]
    stacked = [torch.stack([o[i] for o in ops]) for i in range(6)]
    if solo_first:
        IN.influence_update(*ops[0][:4], row_mask=ops[0][4],
                            prev_mask=ops[0][5], col_mask=ops[0][6],
                            jmask=ops[0][7],
                            block_count=torch.zeros(1, dtype=torch.int64,
                                                    device=cuda))
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    before = IN.influence_update.launches
    out = torch.func.vmap(
        lambda hp, J, M, Mb, row, prev: IN.influence_update(
            hp, J, M, Mb, row_mask=row, prev_mask=prev, col_mask=ops[0][6],
            jmask=ops[0][7], block_count=count))(*stacked)
    torch.cuda.synchronize()
    assert IN.influence_update.launches == before + 1
    want_blocks = 0
    for s, o in enumerate(ops):
        masks = dict(row_mask=o[4], prev_mask=o[5], col_mask=o[6],
                     jmask=o[7])
        ref = IN.influence_reference(*o[:4], **masks)
        scale = max(float(ref.abs().max()), 1.0)
        assert float((out[s] - ref).abs().max()) <= F32_REL * scale
        total = 4 * o[4].shape[1] * o[5].shape[1] * o[6].shape[0]
        a = slots[s]
        want_blocks += round(OPS.realized_block_savings(a[0], a[2], a[4], a[5])
                             * total)
    assert int(count) == want_blocks


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


def _wkv_operands(device, dtype, B, H, T, D, *, ww=None, with_S0=False, seed=0):
    """r/k/v in `dtype`, logw f32 (from -exp(normal), or the constant
    -exp(ww)), u f32, and an optional f32 initial state, on `device`."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.normal(size=(B, H, T, D)) if ww is None
                   else np.full((B, H, T, D), ww)).astype(np.float32)
    u = rng.normal(size=(H, D)).astype(np.float32)
    S0 = rng.normal(size=(B, H, D, D)).astype(np.float32) if with_S0 else None
    t = lambda a: None if a is None else torch.from_numpy(a).to(device)
    return [t(r).to(dtype), t(k).to(dtype), t(v).to(dtype), t(logw), t(u), t(S0)]


def _close_or_one_bf16_step(got, want, bf16):
    err = (got - want).abs()
    scale = max(float(want.abs().max()), 1.0)
    if bf16:
        assert bool((err <= BF16_STEP * want.abs() + F32_REL * scale).all())
    else:
        assert float(err.max()) <= F32_REL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,D,L,ww,with_S0", [
    (2, 3, 64, 64, 16, None, False),     # RWKV6-3B's head and chunk
    (2, 3, 64, 64, 16, None, True),      # a given initial state
    (1, 2, 16, 64, 16, None, True),      # T == L
    (1, 2, 8, 64, 8, None, False),       # T < chunk: wkv_full takes L = T
    (2, 2, 32, 16, 8, 10.0, True),       # logw = -e^10 (clip end)
    (2, 2, 32, 16, 8, -20.0, True),      # logw = -e^-20 (clip end)
    (1, 1, 96, 64, 32, None, False),     # a chunk past 48 KB of shared memory
    (2, 3, 64, 32, 16, None, True),      # D = 32: one CTA a head, no cluster
    (1, 2, 64, 48, 16, None, True),      # D = 48: three 16-column CTAs a head
    (8, 40, 64, 64, 16, None, True),     # 640 CTAs: more than one wave
    (1, 2, 128, 64, 64, None, True),     # L = 64, the longest chunk
])
def test_wkv_kernel_matches_plain_version(cuda, dtype, B, H, T, D, L, ww,
                                          with_S0):
    ops = _wkv_operands(cuda, dtype, B, H, T, D, ww=ww, with_S0=with_S0)
    before = WK.wkv.launches
    o, S = WK.wkv(*ops, chunk=L)
    torch.cuda.synchronize()
    assert WK.wkv.launches == before + 1
    o_ref, S_ref = WK.wkv_reference(*ops, chunk=L)
    assert WK.wkv.launches == before + 1
    assert o.dtype == S.dtype == torch.float32
    assert bool(torch.isfinite(o).all() and torch.isfinite(S).all())
    _close_or_one_bf16_step(o, o_ref, dtype == torch.bfloat16)
    _close_or_one_bf16_step(S, S_ref, dtype == torch.bfloat16)


@pytest.mark.cuda
def test_wkv_kernel_rejects_bad_operands(cuda):
    r, k, v, logw, u, _ = _wkv_operands(cuda, torch.float32, 1, 2, 32, 16)
    with pytest.raises(TypeError, match="logw"):
        WK.wkv(r, k, v, logw.bfloat16(), u, chunk=8)
    with pytest.raises(TypeError, match="k must be"):
        WK.wkv(r, k.bfloat16(), v, logw, u, chunk=8)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        WK.wkv(r, k, v, logw, u, chunk=12)
    with pytest.raises(ValueError, match="u is on cpu"):
        WK.wkv(r, k, v, logw, u.cpu(), chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        WK.wkv(r, k, v.transpose(2, 3).contiguous().transpose(2, 3), logw, u,
               chunk=8)
    with pytest.raises(ValueError, match="D <= 64"):
        WK.wkv(*(torch.zeros((1, 1, 8, 128), device=cuda) for _ in range(4)),
               torch.zeros((1, 128), device=cuda), chunk=8)
    for D in (8, 24):        # a CTA owns 16 or 32 value columns
        with pytest.raises(ValueError, match="a multiple of 16"):
            WK.wkv(*(torch.zeros((1, 1, 8, D), device=cuda) for _ in range(4)),
                   torch.zeros((1, D), device=cuda), chunk=8)
    shifted = torch.zeros(r.numel() + 1, device=cuda)[1:].view(r.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        WK.wkv(shifted, k, v, logw, u, chunk=8)


def _refusal_case(name, device):
    """(wrapper, args, kwargs, index of a float operand) for one kernel."""
    if name == "fused_update":
        return CF.fused_update, _operands(device, torch.float32, 3, 16, 40, 384), {}, 1
    if name == "influence_update":
        arrays = _k2_operands(2, 16, 256, beta=0.2, dead_example=False,
                              masked=True, zero_M=False)
        t = [None if a is None else torch.from_numpy(a).to(device) for a in arrays]
        ops = list(OPS.influence_operands(*t))
        return (IN.influence_update, ops[:4], dict(
            row_mask=ops[4], prev_mask=ops[5], col_mask=ops[6], jmask=ops[7]), 2)
    if name == "event_matmul":
        a_p, R_p, act, rm = OPS.event_matmul_operands(
            torch.ones((2, 16), device=device), torch.ones((16, 128), device=device))
        return EM.event_matmul, [a_p, R_p], dict(act_mask=act, rmask=rm), 1
    return WK.wkv, _wkv_operands(device, torch.float32, 1, 2, 32, 16)[:5], dict(chunk=8), 3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_update", "influence_update",
                                  "event_matmul", "wkv"])
def test_kernel_wrappers_refuse_autograd(cuda, name):
    """A kernel has no backward: an operand that requires grad under grad
    mode raises before any launch; under torch.no_grad() the call runs."""
    fn, args, kwargs, i = _refusal_case(name, cuda)
    args = list(args)
    args[i] = args[i].clone().requires_grad_(True)
    before = fn.launches
    with pytest.raises(RuntimeError, match=r"call under torch\.no_grad\(\)"):
        fn(*args, **kwargs)
    assert fn.launches == before
    with torch.no_grad():
        out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    first = out[0] if isinstance(out, tuple) else out
    assert not first.requires_grad and bool(first.float().isfinite().all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,n,m,density", [(32, 16, 16, 1.0), (32, 256, 768, 0.5),
                                           (1, 40, 130, 1.0), (3, 24, 256, 0.0)])
def test_event_matmul_kernel_matches_plain_version(cuda, dtype, B, n, m, density):
    rng = np.random.default_rng(n + m)
    a = rng.normal(size=(B, n)).astype(np.float32)
    a[rng.random((B, n)) > density] = 0.0
    R = rng.normal(size=(n, m)).astype(np.float32)
    rmask = (rng.random((n, m)) < 0.7).astype(np.float32)
    a, R, rmask = (torch.from_numpy(x).to(cuda) for x in (a, R, rmask))
    a_p, R_p, act, rm = OPS.event_matmul_operands(a.to(dtype), R.to(dtype), rmask)
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    before = EM.event_matmul.launches
    y = EM.event_matmul(a_p, R_p, act_mask=act, rmask=rm, block_count=count)
    torch.cuda.synchronize()
    assert EM.event_matmul.launches == before + 1
    ref = EM.event_matmul_reference(a_p, R_p, act_mask=act, rmask=rm)
    assert y.dtype == dtype and y.shape == ref.shape
    _close_or_one_bf16_step(y.float(), ref.float(), dtype == torch.bfloat16)
    assert int(count) == int(EM.executed_blocks(act, rm))
    got = OPS.event_matmul(a.to(dtype), R.to(dtype), rmask)   # the cropped front end
    assert tuple(got.shape) == (B, m)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 9, 32])
def test_event_matmul_kernel_at_example_group_edges(cuda, dtype, B):
    """A CTA holds up to 8 examples: one example, a full group plus one,
    four full groups; 9 l-blocks, 3 column tiles, block density 0.5."""
    n, m = 72, 384
    rng = np.random.default_rng(B)
    act = rng.random((B, n // 8)) < 0.5
    blocks = rng.random((n // 8, m // 128)) < 0.5
    a = rng.normal(size=(B, n)).astype(np.float32) * np.repeat(act, 8, 1)
    rmask = np.kron(blocks, np.ones((8, 128))).astype(np.float32)
    R = rng.normal(size=(n, m)).astype(np.float32)
    a, R, rmask = (torch.from_numpy(x).to(cuda) for x in (a, R, rmask))
    a_p, R_p, act_m, rm = OPS.event_matmul_operands(a.to(dtype), R.to(dtype),
                                                    rmask)
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    y = EM.event_matmul(a_p, R_p, act_mask=act_m, rmask=rm, block_count=count)
    torch.cuda.synchronize()
    ref = EM.event_matmul_reference(a_p, R_p, act_mask=act_m, rmask=rm)
    assert y.dtype == dtype and y.shape == ref.shape
    _close_or_one_bf16_step(y.float(), ref.float(), dtype == torch.bfloat16)
    assert int(count) == int((act[:, :, None] & blocks[None]).sum())


@pytest.mark.cuda
def test_event_matmul_kernel_rejects_bad_operands(cuda):
    a_p, R_p, act, rm = OPS.event_matmul_operands(
        torch.ones((2, 16), device=cuda), torch.ones((16, 128), device=cuda))
    with pytest.raises(TypeError, match="a must be"):
        EM.event_matmul(a_p.bfloat16(), R_p, act_mask=act, rmask=rm)
    with pytest.raises(TypeError, match="act_mask"):
        EM.event_matmul(a_p, R_p, act_mask=act.long(), rmask=rm)
    with pytest.raises(ValueError, match="rmask is on cpu"):
        EM.event_matmul(a_p, R_p, act_mask=act, rmask=rm.cpu())
    with pytest.raises(ValueError, match="padded shapes"):
        EM.event_matmul(a_p[:, :12].contiguous(), R_p[:12].contiguous(),
                        act_mask=act, rmask=rm)
    with pytest.raises(TypeError, match="block_count"):
        EM.event_matmul(a_p, R_p, act_mask=act, rmask=rm,
                        block_count=torch.zeros(1, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("scan", [False, True])
def test_rwkv_prefill_on_cuda_matches_cpu(cuda, scan):
    """The smoke RWKV6 model (2 layers, f32): a CUDA prefill launches K4
    once per layer and agrees with the same prefill on the CPU; decoding on
    from its cache agrees too."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import rwkv as RW
    from repro_torch.models.module import materialize
    from repro_torch.tree import tree_map
    cfg = smoke_config(get_config("rwkv6-3b")).replace(scan_layers=scan)
    params = materialize(RW.rwkv_model_specs(cfg), torch.Generator().manual_seed(0))
    gpu = tree_map(lambda t: t.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 32)))
    before = WK.wkv.launches
    lg, cg = RW.prefill(cfg, gpu, toks.to(cuda))
    assert WK.wkv.launches == before + cfg.n_layers
    lc, cc = RW.prefill(cfg, params, toks)
    scale = max(float(lc.abs().max()), 1.0)
    assert float((lg.cpu() - lc).abs().max()) <= F32_REL * scale
    nxt = lc.argmax(-1)[:, None]
    dg, _ = RW.decode_step(cfg, gpu, nxt.to(cuda), cg, None)
    dc, _ = RW.decode_step(cfg, params, nxt, cc, None)
    scale = max(float(dc.abs().max()), 1.0)
    assert float((dg.cpu() - dc).abs().max()) <= F32_REL * scale


def _launches():
    return CF.fused_update.launches, IN.influence_update.launches


def _checkpoints_bitwise(root_a, root_b, like):
    """Every leaf but the RNG key data bit for bit."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.tree import tree_flatten_with_path
    ta, sa = load_checkpoint(root_a, like)
    tb, sb = load_checkpoint(root_b, like)
    assert sa == sb >= 0
    for (path, a), (_, b) in zip(tree_flatten_with_path(ta),
                                 tree_flatten_with_path(tb)):
        if path == ("key",):
            continue
        if isinstance(a, torch.Tensor):
            assert a.device.type == "cuda", path
            assert torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8)), path
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,dtype", [("compact_fused", "float32"),
                                           ("compact_fused", "bfloat16"),
                                           ("pallas", "float32")])
def test_online_crash_resume_on_cuda_is_bitwise(cuda, backend, dtype,
                                                tmp_path):
    """A crash at update 7 of 10 with a checkpoint every 5 replays updates
    6-7 through the kernel (96 launches against 80) and ends bit for bit
    where the uncrashed run ends."""
    from repro_torch.launch import train as TRAIN
    argv = ["--arch", "egru-spiral", "--online", "--rtrl-backend", backend,
            "--sparsity", "0.8", "--update-every", "8", "--steps", "10",
            "--ckpt-every", "5", "--influence-dtype", dtype]
    slot = 0 if backend == "compact_fused" else 1
    runs = {}
    for name, extra in (("a", ["--fail-at", "7"]), ("b", [])):
        before = _launches()
        runs[name] = TRAIN.main([*argv, *extra, "--ckpt-dir",
                                 str(tmp_path / name)])
        runs[name]["launched"] = _launches()[slot] - before[slot]
    assert (runs["a"]["restarts"], runs["b"]["restarts"]) == (1, 0)
    assert runs["a"]["final_step"] == runs["b"]["final_step"] == 80
    assert (runs["a"]["launched"], runs["b"]["launched"]) == (96, 80)
    b_loss = {w["update"]: w["loss"] for w in runs["b"]["windows"]}
    assert [w["loss"] for w in runs["a"]["windows"]] == \
        [b_loss[u] for u in range(6, 11)]
    args = TRAIN.parse_args([*argv, "--ckpt-dir", str(tmp_path / "like")])
    like = TRAIN.online_trainers(args, TRAIN.build_online(args))(1) \
        ._ckpt_tree()
    _checkpoints_bitwise(tmp_path / "a", tmp_path / "b", like)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["compact_fused", "pallas"])
def test_offline_crash_resume_on_cuda(cuda, backend, tmp_path):
    """Offline on the card: 17 launches a step (170 in 10 steps; 204 with
    the crash at step 7 replaying steps 6-7), the crashed run's final
    checkpoint bit for bit the uncrashed one's, and the first step's loss
    and gradients within F32_REL of the offline compact backend's."""
    from repro_torch.launch import train as TRAIN
    from repro_torch.tree import tree_leaves
    argv = ["--arch", "egru-spiral", "--rtrl-backend", backend, "--sparsity",
            "0.8", "--steps", "10", "--ckpt-every", "5"]
    slot = 0 if backend == "compact_fused" else 1
    runs = {}
    for name, extra in (("a", ["--fail-at", "7"]), ("b", [])):
        before = _launches()
        runs[name] = TRAIN.main([*argv, *extra, "--ckpt-dir",
                                 str(tmp_path / name)])
        runs[name]["launched"] = _launches()[slot] - before[slot]
    assert (runs["a"]["restarts"], runs["b"]["restarts"]) == (1, 0)
    assert (runs["a"]["launched"], runs["b"]["launched"]) == (204, 170)
    args = TRAIN.parse_args([*argv, "--ckpt-dir", str(tmp_path / "like")])
    run = TRAIN.build_offline(args)
    _checkpoints_bitwise(tmp_path / "a", tmp_path / "b",
                         TRAIN.offline_trainers(args, run)(1)._ckpt_tree())
    ref = TRAIN.build_offline(TRAIN.parse_args(
        ["--rtrl-backend", "compact", "--sparsity", "0.8"]))
    xs, ys = run["data_at"](0)
    lb, gb, _ = run["loss_and_grads"](run["params"], xs, ys)
    lc, gc, _ = ref["loss_and_grads"](ref["params"], xs, ys)
    assert float(lb) == pytest.approx(float(lc), rel=F32_REL)
    for a, b in zip(tree_leaves(gb), tree_leaves(gc)):
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) <= F32_REL * scale


def _stacked_layer1_operands(backend, steps=5):
    """Layer 1's kernel operands at a live step of `--layers 2` on the
    card: the launcher's run stepped a few times, then layer 0 and layer 1
    of the next step, the cross term folded into layer 1's M-bar.  K1:
    the fused_update tuple; K2: the unpadded (hp, J-hat, M, M-bar, jmask,
    col_mask), col_mask the layer's compact-axis liveness."""
    from repro_torch.core import sparse_rtrl as SP
    from repro_torch.launch import train as TRAIN
    from repro_torch.runtime import online as ON
    run = TRAIN.build_online(TRAIN.parse_args(
        ["--arch", "egru-spiral", "--online", "--layers", "2",
         "--rtrl-backend", backend, "--sparsity", "0.8"]))
    learner, cfg = run["learner"], run["cfg"]
    xs, ys = zip(*(run["stream"](t) for t in range(steps + 1)))
    xs = torch.from_numpy(np.stack(xs)).to(run["device"])
    ys = torch.from_numpy(np.stack(ys)).to(run["device"])
    carry = learner.init(run["params"], run["masks"], (xs[0], ys[0]), 8.0)
    carry, _, _, _ = ON.stream_grads(learner, carry, xs[:steps], ys[:steps])
    ws, sl = carry["params"]["layers"], learner.slayout
    inp, below = xs[steps], None
    for l in range(2):
        lcfg = cfg.layer_cfg(l)
        if backend == "compact_fused":
            inp, _, ops, _ = SP.fused_step_operands(
                lcfg, ws[l], sl.layers[l], carry["a"][l], carry["vals"][l],
                carry["idx"][l], inp, cl=learner._cl, layer=l, below=below)
            below = (CF.fused_reference(*ops), ops[4])
        else:
            inp, _, ops = SP.pallas_step_operands(
                lcfg, ws[l], sl.layers[l], carry["a"][l], carry["M"][l], inp,
                cl=learner._cl, col_mask=learner._klives[l],
                jmask=SP.flat_jmask(lcfg, run["masks"][l]), layer=l,
                M_below=below)
            below = ops[0][:, :, None] * (torch.bmm(ops[1], ops[2]) + ops[3])
    return list(ops)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_stacked_layer1_operands(cuda, dtype):
    """K1 at layer 1 of `--layers 2`: the M-bar rows carry the cross term;
    the compact axis is the shared stacked one (Pc_pad 640)."""
    ops = _stacked_layer1_operands("compact_fused")
    assert ops[1].shape[-1] % 128 == 0 and ops[1].shape[-1] >= 512
    _check_fused([ops[0], ops[1].to(dtype), *ops[2:]], dtype)


@pytest.mark.cuda
def test_influence_kernel_at_stacked_layer1_operands(cuda):
    """K2 at layer 1 of `--layers 2`, against its plain version, dead blocks
    exactly 0 and the executed-block counter equal to
    realized_block_savings times the block count."""
    hp, J, M, Mbar, jmask, col_mask = _stacked_layer1_operands("pallas")
    ops = OPS.influence_operands(hp, J, M, Mbar, jmask, col_mask)
    masks = dict(row_mask=ops[4], prev_mask=ops[5], col_mask=ops[6],
                 jmask=ops[7])
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    out = IN.influence_update(*ops[:4], **masks, block_count=count)
    ref = IN.influence_reference(*ops[:4], **masks)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= F32_REL * scale
    total = ops[2].shape[0] * ops[4].shape[1] * ops[5].shape[1] * \
        ops[6].shape[0]
    expect = OPS.realized_block_savings(hp, M, jmask, col_mask) * total
    assert int(count) == round(expect)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["compact_fused", "pallas"])
def test_stacked_first_window_on_cuda_matches_cpu(cuda, backend):
    """`--layers 2`: one launch a layer a stream step (16 over 8 steps),
    and the first window's loss and gradients within F32_REL of the CPU's
    plain versions."""
    from repro_torch.launch import train as TRAIN
    from repro_torch.runtime import online as ON
    from repro_torch.tree import tree_leaves

    def window(device):
        argv = ["--arch", "egru-spiral", "--online", "--layers", "2",
                "--rtrl-backend", backend, "--sparsity", "0.8", "--device",
                device]
        run = TRAIN.build_online(TRAIN.parse_args(argv))
        xs, ys = zip(*(run["stream"](t) for t in range(8)))
        xs = torch.from_numpy(np.stack(xs)).to(run["device"])
        ys = torch.from_numpy(np.stack(ys)).to(run["device"])
        carry = run["learner"].init(run["params"], run["masks"],
                                    (xs[0], ys[0]), t_total=8.0)
        _, loss, grads, _ = ON.stream_grads(run["learner"], carry, xs, ys)
        return float(loss), tree_leaves(grads)

    slot = 0 if backend == "compact_fused" else 1
    before = _launches()
    lg, gg = window("cuda")
    assert _launches()[slot] - before[slot] == 16
    lc, gc = window("cpu")
    assert lg == pytest.approx(lc, rel=F32_REL)
    for a, b in zip(gg, gc):
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a.cpu() - b).abs().max()) <= F32_REL * scale


def _rewired_pallas_run(device, *extra):
    """The launcher's rewired pallas run (`--rewire rigl`) on `device`: its
    carry and optimizer state after one window and event 0, and the next
    window's inputs."""
    from repro_torch.launch import train as TRAIN
    from repro_torch.optim.optimizers import set_opt_mask
    from repro_torch.runtime import online as ON
    from repro_torch.sparsity import RewireSchedule
    run = TRAIN.build_online(TRAIN.parse_args(
        ["--arch", "egru-spiral", "--online", "--rtrl-backend", "pallas",
         "--sparsity", "0.8", "--rewire", "rigl", "--device", device,
         *extra]))
    learner, opt = run["learner"], run["opt"]
    xs, ys = zip(*(run["stream"](t) for t in range(16)))
    xs = torch.from_numpy(np.stack(xs)).to(run["device"])
    ys = torch.from_numpy(np.stack(ys)).to(run["device"])
    carry = learner.init(run["params"], run["masks"], (xs[0], ys[0]), 8.0)
    carry, opt_state, _ = ON.online_update_chunk(
        learner, opt, carry, opt.init(run["params"]), xs[:8], ys[:8], 0)
    carry = learner.rewire(carry, RewireSchedule.event_key(0, 0), frac=0.3)
    opt_state = set_opt_mask(opt_state, learner.opt_mask_of(carry))
    return run, carry, opt_state, xs[8:], ys[8:]


@pytest.mark.cuda
@pytest.mark.parametrize("col", ["on", "off"])
def test_influence_kernel_after_rewire_event(cuda, col):
    """K2 at the first step after a RigL event: the learner's rebuilt
    constant block masks equal those of the new masks, the kernel agrees
    with its plain version, and its executed-block counter equals
    realized_block_savings of the new masks times the block count."""
    from repro_torch.core import cells as Cc, sparse_rtrl as SP
    run, carry, _, xs, _ = _rewired_pallas_run("cuda", "--col-compact", col)
    inner = run["learner"].inner
    assert inner._bound is carry["rw"]
    hp, J, M, Mbar, jmask, colm = SP.pallas_step_operands(
        inner.cfg, Cc.rec_param_tree(carry["params"]), inner.layout,
        carry["a"], carry["M"], xs[0], cl=inner._cl, col_mask=inner._colm,
        jmask=inner._jm)[2]
    assert torch.equal(jmask, SP.flat_jmask(inner.cfg, carry["rw"]["masks"]))
    ops = OPS.influence_operands(hp, J, M, Mbar, block_masks=inner._kmasks)
    fresh = OPS.influence_operands(hp, J, M, Mbar, jmask, colm)
    for a, b in zip(ops, fresh):
        assert torch.equal(a, b)
    masks = dict(row_mask=ops[4], prev_mask=ops[5], col_mask=ops[6],
                 jmask=ops[7])
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    out = IN.influence_update(*ops[:4], **masks, block_count=count)
    ref = IN.influence_reference(*ops[:4], **masks)
    assert float((out - ref).abs().max()) <= F32_REL * max(
        float(ref.abs().max()), 1.0)
    total = ops[2].shape[0] * ops[4].shape[1] * ops[5].shape[1] * \
        ops[6].shape[0]
    assert int(count) == round(OPS.realized_block_savings(hp, M, jmask, colm)
                               * total)


@pytest.mark.cuda
@pytest.mark.parametrize("layers", ["1", "2"])
def test_rewired_pallas_window_matches_restart_oracle(cuda, layers):
    """A window after event 0 on the card, K2 launched once a layer a step:
    loss and gradients within F32_REL of the dense restart oracle's."""
    from repro_torch.runtime import online as ON
    from repro_torch.sparsity.migrate import restart_oracle
    from repro_torch.tree import tree_leaves
    run, carry, _, xs, ys = _rewired_pallas_run("cuda", "--layers", layers)
    oracle, oc = restart_oracle(run["learner"], carry)
    before = _launches()
    _, loss, grads, _ = ON.stream_grads(run["learner"], carry, xs, ys)
    assert _launches()[1] - before[1] == 8 * int(layers)
    _, oloss, ograds, _ = ON.stream_grads(oracle, oc, xs, ys)
    assert float(loss) == pytest.approx(float(oloss), rel=F32_REL)
    for a, b in zip(tree_leaves(grads), tree_leaves(ograds)):
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) <= F32_REL * scale


@pytest.mark.cuda
def test_guarded_compact_fused_window_bitwise_on_cuda(cuda):
    """The guarded chunk with clip = inf on the card: K1 launched 8 times,
    health 0, and the carry, optimizer state and loss bitwise the
    unguarded chunk's."""
    from repro_torch.launch import train as TRAIN
    from repro_torch.runtime import guard as G, online as ON
    from repro_torch.tree import tree_leaves
    run = TRAIN.build_online(TRAIN.parse_args(
        ["--arch", "egru-spiral", "--online", "--rtrl-backend",
         "compact_fused", "--sparsity", "0.8"]))
    learner, opt = run["learner"], run["opt"]
    xs, ys = zip(*(run["stream"](t) for t in range(8)))
    xs = torch.from_numpy(np.stack(xs)).to(cuda)
    ys = torch.from_numpy(np.stack(ys)).to(cuda)
    carry = learner.init(run["params"], run["masks"], (xs[0], ys[0]), 8.0)
    state = opt.init(run["params"])
    c_a, o_a, m_a = ON.online_update_chunk(learner, opt, carry, state, xs,
                                           ys, 0)
    before = _launches()
    c_b, o_b, m_b = G.guarded_update_chunk(learner, opt, carry, state, xs,
                                           ys, 0, float("inf"))
    assert _launches()[0] - before[0] == 8
    assert int(m_b["health"]) == 0
    assert torch.equal(m_a["loss"], m_b["loss"])
    for a, b in zip(tree_leaves((c_a, o_a)), tree_leaves((c_b, o_b))):
        assert torch.equal(a, b)


def _poisoned_trees(device):
    """(tree, nonfinite?) pairs: a tree of f32, bf16, f16 and f64 leaves
    and an int32 leaf, clean, with finite extremes, and with one NaN, inf
    or -inf at the first or last element of one leaf."""
    def tree():
        g = torch.Generator().manual_seed(0)
        return {"vals": torch.randn(4, 6, 1000, generator=g),
                "M": (torch.randn(3, 5, generator=g).bfloat16(),
                      torch.randn(7, generator=g).half()),
                "a": torch.randn(2, 3, generator=g).double(),
                "idx": torch.full((4, 6), 2 ** 31 - 1, dtype=torch.int32)}
    out = [(tree(), False)]
    big = tree()
    big["vals"][0, 0, 0] = 3.0e38
    big["M"][0][0, 0] = torch.finfo(torch.bfloat16).max
    out.append((big, False))
    for pick in (lambda t: t["vals"], lambda t: t["M"][0],
                 lambda t: t["M"][1], lambda t: t["a"]):
        for value in (float("nan"), float("inf"), -float("inf")):
            for pos in (0, -1):
                t = tree()
                pick(t).view(-1)[pos] = value
                out.append((t, True))
    return [({k: (tuple(x.to(device) for x in v) if isinstance(v, tuple)
                  else v.to(device)) for k, v in t.items()}, bad)
            for t, bad in out]


@pytest.mark.cuda
def test_health_checks_on_the_card_equal_the_cpu(cuda):
    """The guard's multi-tensor finite check on the card: the per-leaf
    verdict on one poisoned element of any leaf and dtype, and none on
    finite extremes; the norm equals the CPU's within f32 round-off."""
    from repro_torch.obs.metricpack import global_norm
    from repro_torch.runtime import guard as G
    cases = _poisoned_trees(cuda)
    cpu = _poisoned_trees("cpu")
    for (tree, bad), (ctree, _) in zip(cases, cpu):
        got = G.health_bits(torch.tensor(1.0, device=cuda), {}, tree)
        assert got.device.type == "cuda"
        assert int(got) == (G.HEALTH_CARRY if bad else 0)
        assert int(G.health_bits(torch.tensor(1.0), {}, ctree)) == int(got)
        if not bad:
            g = {k: v for k, v in tree.items() if k != "idx"}
            gc = {k: v for k, v in ctree.items() if k != "idx"}
            a, b = float(global_norm(g)), float(global_norm(gc))
            assert a == pytest.approx(b, rel=F32_REL)


@pytest.mark.cuda
def test_packed_window_on_the_card_issues_no_sync(cuda):
    """The packed compact_fused chunk on the card: K1 launched 8 times, the
    carry and optimizer state bitwise the bare chunk's, and the pack, the
    finite checks and the norm run under torch's sync debug mode set to
    error — no field reads a value back; `unpack` is the readback."""
    from repro_torch.launch import train as TRAIN
    from repro_torch.obs import MetricPack
    from repro_torch.runtime import guard as G, online as ON
    from repro_torch.tree import tree_leaves
    run = TRAIN.build_online(TRAIN.parse_args(
        ["--arch", "egru-spiral", "--online", "--rtrl-backend",
         "compact_fused", "--sparsity", "0.8"]))
    learner, opt = run["learner"], run["opt"]
    xs, ys = zip(*(run["stream"](t) for t in range(8)))
    xs = torch.from_numpy(np.stack(xs)).to(cuda)
    ys = torch.from_numpy(np.stack(ys)).to(cuda)
    carry = learner.init(run["params"], run["masks"], (xs[0], ys[0]), 8.0)
    state = opt.init(run["params"])
    pack = MetricPack.default()
    c_a, o_a, m_a = ON.online_update_chunk(learner, opt, carry, state, xs,
                                           ys, 0)
    c_g, o_g, m_g = G.guarded_update_chunk(learner, opt, carry, state, xs,
                                           ys, 0, float("inf"), pack=pack)
    before = _launches()
    c_b, o_b, m_b = ON.online_update_chunk(learner, opt, carry, state, xs,
                                           ys, 0, pack=pack)
    assert _launches()[0] - before[0] == 8
    for a, b, c in zip(tree_leaves((c_a, o_a)), tree_leaves((c_b, o_b)),
                       tree_leaves((c_g, o_g))):
        assert torch.equal(a, b) and torch.equal(a, c)
    _, loss, grads, stats = ON.stream_grads(learner, carry, xs, ys)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vec = pack.pack({"loss": loss, "grads": grads, "stats": stats,
                         "carry": c_b})
        bits = G.health_bits(loss, grads, c_b)
        gn = G.global_norm(grads)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert vec.device.type == "cuda" and bits.device.type == "cuda"
    assert gn.device.type == "cuda"
    pk = pack.unpack(m_b["packed"])
    finite = lambda d: {k: v for k, v in d.items() if v == v}
    assert finite(pk) == finite(pack.unpack(vec))
    assert np.float32(pk["loss"]) == m_a["loss"].item()
    assert np.float32(pk["act_sparsity"]) == m_a["alpha"].item()
    assert pk["kb_max"] <= 16 and pk["health"] == 0.0
    assert pack.unpack(m_g["packed"])["clip_factor"] == 1.0


def _lm_window(argv):
    """The first window (k=8) of an online token-LM launcher run, with the
    BPTT oracle's through the same window on the run's device (the pruned
    parameters' gradients masked as the optimizer masks them)."""
    from repro_torch.cells import resolve_cell
    from repro_torch.core import bptt as BP
    from repro_torch.launch import train as TRAIN
    from repro_torch.runtime import online as ON
    from repro_torch.tree import apply_mask_tree
    run = TRAIN.build_lm(TRAIN.parse_args(argv))
    xs, ys = zip(*(run["stream"](t) for t in range(8)))
    xs = torch.from_numpy(np.stack(xs)).to(run["device"])
    ys = torch.from_numpy(np.stack(ys)).to(run["device"])
    carry = run["learner"].init(run["params"], run["masks"], (xs[0], ys[0]),
                                t_total=8.0)
    _, loss, grads, _ = ON.stream_grads(run["learner"], carry, xs, ys)
    bloss, bgrads = BP.window_bptt_loss_and_grads(resolve_cell(run["cfg"]),
                                                  run["params"], xs, ys)
    if run["masks"] is not None:
        bgrads = apply_mask_tree(run["masks"], bgrads)
    return float(loss), grads, float(bloss), bgrads


@pytest.mark.cuda
@pytest.mark.parametrize("arch,extra", [
    ("egru-lm", ("--rtrl-backend", "compact_fused", "--sparsity", "0.8")),
    ("egru-lm", ("--rtrl-backend", "pallas", "--sparsity", "0.8")),
    ("egru-lm", ("--rtrl-backend", "pallas",)),
    ("rglru-lm", ("--sparsity", "0.5")), ("snn-lm", ())])
def test_lm_first_window_on_cuda_matches_cpu_and_oracle(cuda, arch, extra):
    """(l1) and (l3) of chip_smoke.py at --smoke: the first window on the
    card (K1 or K2 launched once a stream step) against the CPU's and
    against the BPTT oracle on the card (e-prop by cosine >= 0.9)."""
    from repro_torch.tree import tree_leaves
    argv = ["--arch", arch, "--online", "--smoke", *extra]
    before = _launches()
    lg, gg, bl, bg = _lm_window(argv)
    launched = tuple(a - b for a, b in zip(_launches(), before))
    backend = extra[1] if arch == "egru-lm" else None
    assert launched == ((8 if backend == "compact_fused" else 0),
                        (8 if backend == "pallas" else 0))
    lc, gc, _, _ = _lm_window([*argv, "--device", "cpu"])
    assert lg == pytest.approx(lc, rel=F32_REL)
    assert lg == pytest.approx(bl, rel=F32_REL)

    def close(a, b):
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a.cpu() - b.cpu()).abs().max()) <= F32_REL * scale

    for a, b in zip(tree_leaves(gg), tree_leaves(gc)):
        close(a, b)
    if arch == "snn-lm":
        for k in ("W", "R"):
            a, b = gg[k].double().flatten(), bg[k].double().flatten()
            assert float(a @ b / (a.norm() * b.norm())) >= 0.9, k
        bg, gg = bg["out"], gg["out"]
    for a, b in zip(tree_leaves(gg), tree_leaves(bg)):
        close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["compact_fused", "pallas"])
def test_lm_launcher_on_cuda_launches_once_a_stream_step(cuda, backend):
    from repro_torch.launch import train as TRAIN
    before = _launches()
    out = TRAIN.main(["--arch", "egru-lm", "--online", "--smoke", "--steps",
                      "3", "--rtrl-backend", backend, "--sparsity", "0.8",
                      "--ckpt-every", "0"])
    launched = tuple(a - b for a, b in zip(_launches(), before))
    assert out["final_step"] == 24 and out["summary"]["device"] == "cuda"
    assert launched == ((24, 0) if backend == "compact_fused" else (0, 24))
    assert all(np.isfinite(w["loss"]) for w in out["windows"])


# ---------------------------------------------------------------------------
# the dense decoders and LM training (smoke configs): the card against the CPU
# ---------------------------------------------------------------------------

def _lm_models(arch, device):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import get_model
    from repro_torch.models.module import materialize
    from repro_torch.tree import tree_map
    cfg = smoke_config(get_config(arch))
    cpu = materialize(get_model(cfg).specs(cfg), torch.Generator().manual_seed(0))
    return cfg, cpu, tree_map(lambda t: t.to(device), cpu)


def _lm_batch(cfg, device, B=2, S=24):
    from repro_torch.data.tokens import synthetic_token_batches
    b = next(synthetic_token_batches(B, S, cfg.vocab_size,
                                     n_patches=cfg.n_patches))
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-8b", "rwkv6-3b"])
def test_lm_loss_and_gradients_on_cuda_match_cpu(cuda, arch):
    from repro_torch.models import get_model
    from repro_torch.optim import microbatch_grads
    from repro_torch.tree import tree_leaves
    cfg, cpu, dev = _lm_models(arch, cuda)
    loss = lambda p, b: get_model(cfg).loss_fn(cfg, p, b)
    lc, gc = microbatch_grads(loss, cpu, _lm_batch(cfg, "cpu"), 1)
    ld, gd = microbatch_grads(loss, dev, _lm_batch(cfg, cuda), 1)
    assert abs(float(ld) - float(lc)) <= F32_REL * abs(float(lc))
    for a, b in zip(tree_leaves(gd), tree_leaves(gc)):
        assert float((a.cpu() - b).abs().max()) <= F32_REL * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-2b", "yi-6b"])
def test_prefill_and_decode_on_cuda_match_cpu_and_the_full_forward(cuda, arch):
    from repro_torch.models import transformer as T
    cfg, cpu, dev = _lm_models(arch, cuda)
    S, n = 24, 8
    toks = torch.randint(0, cfg.vocab_size, (2, S + n),
                         generator=torch.Generator().manual_seed(1))
    full = T.forward_logits(cfg, dev, toks.to(cuda), start=S - 1)
    lg, cache = T.prefill(cfg, dev, toks[:, :S].to(cuda), max_seq=S + n)
    lc, _ = T.prefill(cfg, cpu, toks[:, :S], max_seq=S + n)
    scale = float(full.abs().max())
    assert float((lg.cpu() - lc).abs().max()) <= F32_REL * scale
    for i in range(n + 1):
        assert float((lg - full[:, i]).abs().max()) <= F32_REL * scale, i
        if i < n:
            lg, cache = T.decode_step(cfg, dev, toks[:, S + i:S + i + 1].to(cuda),
                                      cache, torch.full((2,), S + i, device=cuda))


@pytest.mark.cuda
def test_rwkv_training_on_cuda_launches_no_wkv_kernel(cuda, tmp_path):
    from repro_torch.launch import train as TRAIN
    before = WK.wkv.launches
    out = TRAIN.main(["--arch", "rwkv6-3b", "--smoke", "--steps", "3",
                      "--ckpt-every", "0", "--ckpt-dir", str(tmp_path)])
    assert WK.wkv.launches == before and out["final_step"] == 3
    assert out["summary"]["device"] == "cuda"
    assert all(np.isfinite(s["loss"]) for s in out["steps"])
