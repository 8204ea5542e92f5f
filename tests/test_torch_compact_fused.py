"""The port's fused dual-compact influence update (repro_torch.kernels.
compact_fused) held against the JAX package's.

On the CPU the wrapper runs the plain PyTorch version, `fused_reference`;
it is compared with the Pallas kernel in interpret mode and with the JAX
oracle on the same numpy operands.  Tolerances: float32 results agree to
1e-5 of the largest magnitude (the two sums associate differently); bf16
results to one bf16 rounding step (2^-7 relative) on top of that, since an
f32 difference at a rounding boundary flips the last bf16 bit.  The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and by chip_smoke.py; the arithmetic of its
tensor-core branch (3xTF32) is modelled here, bit for bit in its roundings,
and held to the f32 tolerance the card's tests use.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse_rtrl as JSP
from repro.core.cells import EGRUConfig as JEGRUConfig
from repro.kernels import compact_fused as JCF
from repro_torch.core import sparse_rtrl as SP
from repro_torch.core.cells import EGRUConfig
from repro_torch.kernels import _build, compact_fused as CF
from repro_torch.weights import masks_from_numpy

F32_RTOL = 1e-5
BF16_STEP = 2.0 ** -7


def _ragged_np(seed, B=3, K=16, n=40, Pc_pad=128, empty_prev=False):
    """Fused-update operands honouring the carry contract (numpy): -1
    sentinels past each example's count, dead vals/hp slots exactly 0,
    heterogeneous counts: one full example, one one-row example and,
    with empty_prev, an example with count_prev = 0."""
    rng = np.random.default_rng(seed)
    count_new = rng.integers(1, K + 1, B).astype(np.int32)
    count_prev = rng.integers(1, K + 1, B).astype(np.int32)
    count_new[0], count_prev[0] = K, K
    count_new[1] = 1
    if empty_prev:
        count_prev[2] = 0
    idx_new = np.full((B, K), -1, np.int32)
    idx_prev = np.full((B, K), -1, np.int32)
    for b in range(B):
        idx_new[b, :count_new[b]] = np.sort(
            rng.choice(n, count_new[b], replace=False))
        idx_prev[b, :count_prev[b]] = np.sort(
            rng.choice(n, count_prev[b], replace=False))
    Jhat = rng.normal(size=(B, n, n)).astype(np.float32)
    vals = rng.normal(size=(B, K, Pc_pad)).astype(np.float32)
    vals[idx_prev < 0] = 0.0
    mbar = rng.normal(size=(B, K, Pc_pad)).astype(np.float32)
    hp = np.abs(rng.normal(size=(B, K))).astype(np.float32)
    hp[idx_new < 0] = 0.0
    return Jhat, vals, mbar, hp, idx_new, idx_prev, count_new, count_prev


def _jax_args(ops, dtype=jnp.float32):
    a = [jnp.asarray(x) for x in ops]
    a[1] = a[1].astype(dtype)
    return a


def _torch_args(ops, dtype=torch.float32, device="cpu"):
    a = [torch.from_numpy(x).to(device) for x in ops]
    a[1] = a[1].to(dtype)
    return a


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_f32_close(got, ref):
    got, ref = _f32(got), _f32(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_RTOL * scale)


def _assert_bf16_close(got, ref):
    got, ref = _f32(got), _f32(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    bound = BF16_STEP * np.abs(ref) + F32_RTOL * scale
    assert (np.abs(got - ref) <= bound).all(), float(np.abs(got - ref).max())


# ---------------------------------------------------------------------------
# plain version vs the Pallas kernel (interpret mode) and the JAX oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,Pc_pad,empty_prev", [
    (0, 128, False), (1, 128, True), (2, 384, False)])
def test_reference_matches_pallas_interpret_f32(seed, Pc_pad, empty_prev):
    ops = _ragged_np(seed, Pc_pad=Pc_pad, empty_prev=empty_prev)
    want = JCF.fused_update_pallas(*_jax_args(ops), interpret=True)
    got = CF.fused_reference(*_torch_args(ops))
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    _assert_f32_close(got, want)
    _assert_f32_close(got, JCF.fused_reference(*_jax_args(ops)))


def test_reference_matches_pallas_interpret_bf16():
    ops = _ragged_np(3, empty_prev=True)
    want = JCF.fused_update_pallas(*_jax_args(ops, jnp.bfloat16),
                                   interpret=True)
    got = CF.fused_reference(*_torch_args(ops, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dead_rows_exact_zero(dtype):
    ops = _ragged_np(4, empty_prev=True)
    out = _f32(CF.fused_update(*_torch_args(ops, dtype)))
    count_new = ops[6]
    for b in range(out.shape[0]):
        assert (out[b, count_new[b]:] == 0.0).all()
        assert np.isfinite(out[b]).all()


def test_wrapper_uses_plain_version_on_cpu_without_launching():
    ops = _torch_args(_ragged_np(5))
    before = CF.fused_update.launches
    out = CF.fused_update(*ops)
    assert CF.fused_update.launches == before
    torch.testing.assert_close(out, CF.fused_reference(*ops), rtol=0, atol=0)


def test_wrapper_raises_on_a_device_without_a_kernel():
    ops = [t.to("meta") for t in _torch_args(_ragged_np(5))]
    with pytest.raises(ValueError, match="no kernel"):
        CF.fused_update(*ops)


def test_reference_tail_block_when_K_not_multiple_of_bl():
    """K = 12 (capacity capped at n = 12): the partial last block counts."""
    ops = _ragged_np(6, K=12, n=12)
    got = CF.fused_reference(*_torch_args(ops))
    Jhat, vals, mbar, hp, idx_new, idx_prev, cn, cp = ops
    want = np.zeros_like(vals)
    for b in range(vals.shape[0]):
        for r in range(cn[b]):
            acc = sum(Jhat[b, idx_new[b, r], idx_prev[b, l]] * vals[b, l]
                      for l in range(cp[b]))
            want[b, r] = hp[b, r] * (acc + mbar[b, r])
    _assert_f32_close(got, want)


# ---------------------------------------------------------------------------
# the tensor-core branch's arithmetic (3xTF32), modelled on the CPU
# ---------------------------------------------------------------------------

def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, by bit arithmetic on its f32 view (finite x): cvt.rna.tf32.f32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32(x):
    """x = hi + lo + a residue below 2^-22 |x|, hi and lo TF32 values."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tensor_core_model(ops, products):
    """The branch's output with its roundings and no other: J-hat and V split
    into TF32 hi + lo, the products V_lo J_hi + V_hi J_lo + V_hi J_hi
    (`products` 3; 1 keeps V_hi J_hi alone, 1xTF32) summed exactly over
    l < count_prev, then hp * (sum + M-bar), rows past count_new zero."""
    Jhat, vals, mbar, hp, idx_new, idx_prev, cn, cp = ops
    out = np.zeros(vals.shape, np.float32)
    for b in range(vals.shape[0]):
        rows, prev = idx_new[b, :cn[b]], idx_prev[b, :cp[b]]
        Jg = np.where((rows[:, None] >= 0) & (prev[None, :] >= 0),
                      Jhat[b][np.ix_(rows, prev)], 0.0).astype(np.float32)
        jh, jl = (m.astype(np.float64) for m in _split_tf32(Jg))
        vh, vl = (m.astype(np.float64) for m in _split_tf32(vals[b, :cp[b]]))
        acc = jh @ vh if products == 1 else jh @ vl + jl @ vh + jh @ vh
        out[b, :cn[b]] = hp[b, :cn[b], None] * (acc + mbar[b, :cn[b]])
    return out


@pytest.mark.parametrize("seed,Pc_pad,empty_prev", [
    (0, 64, False), (1, 64, True), (2, 136, False)])
def test_tensor_core_arithmetic_holds_the_f32_tolerance(seed, Pc_pad,
                                                        empty_prev):
    """At K = n = 1,024 on ragged operands, 3xTF32 agrees with the plain
    version to 1e-6 of the largest magnitude; 1xTF32 is at least 10x
    further off, so the two small products are what holds the tolerance."""
    ops = _ragged_np(seed, B=3, K=1024, n=1024, Pc_pad=Pc_pad,
                     empty_prev=empty_prev)
    ref = _f32(CF.fused_reference(*_torch_args(ops)))
    scale = float(np.abs(ref).max())
    err3 = float(np.abs(_tensor_core_model(ops, 3) - ref).max())
    err1 = float(np.abs(_tensor_core_model(ops, 1) - ref).max())
    assert err3 <= 1e-6 * scale, (err3, scale)
    assert err1 >= 10 * err3, (err1, err3)


def test_tf32_rounding_is_nearest_ties_away():
    """The model's rounding on hand-picked f32 values: below, at and above
    the halfway point of the 13 dropped bits, for both signs."""
    one_ulp = 2.0 ** -10                      # TF32's step at 1.0
    x = np.array([1.0 + one_ulp / 2 - 2.0 ** -23, 1.0 + one_ulp / 2,
                  1.0 + one_ulp / 2 + 2.0 ** -23], np.float32)
    np.testing.assert_array_equal(_tf32(x), [1.0, 1.0 + one_ulp,
                                             1.0 + one_ulp])
    np.testing.assert_array_equal(_tf32(-x), -_tf32(x))
    pi = np.array([np.pi], np.float32)
    hi, lo = _split_tf32(pi)
    assert hi[0] != pi[0] and abs(float(hi[0]) + float(lo[0]) - float(pi[0])) \
        <= 2.0 ** -22 * np.pi


def test_tensor_core_branch_is_chosen_by_capacity_and_dtype():
    """The branch the wrapper counts in `tc_launches`: an f32 carry at
    TC_MIN_K <= K <= TC_MAX_K; K <= 64 and every bf16 carry keep the CUDA
    cores."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert 64 < CF.TC_MIN_K <= 512 <= CF.TC_MAX_K
    lo, hi = CF.TC_MIN_K, CF.TC_MAX_K
    assert [CF.tensor_cores(K, f32) for K in (16, 64, lo - 1, lo, 1024, hi,
                                              hi + 1)] == \
        [False, False, False, True, True, True, False]
    assert not any(CF.tensor_cores(K, bf16) for K in (16, 128, 1024))


# ---------------------------------------------------------------------------
# host-side tables
# ---------------------------------------------------------------------------

def test_capacity_ladder_matches_reference():
    for K in (8, 16, 24, 64, 136, 152, 256):
        assert CF.capacity_ladder(K) == JCF.capacity_ladder(K)


@pytest.mark.parametrize("kind,sparsity", [("gru", 0.6), ("rnn", 0.5),
                                           ("gru", None)])
def test_fused_segments_match_reference(kind, sparsity):
    jcfg = JEGRUConfig(n_hidden=16, n_in=5, n_out=3, kind=kind)
    cfg = EGRUConfig(n_hidden=16, n_in=5, n_out=3, kind=kind)
    rng = np.random.default_rng(11)
    masks_np = None
    if sparsity is not None:
        gates = ("v",) if kind == "rnn" else ("u", "r", "z")
        masks_np = {g: {"W": (rng.random((5, 16)) >= sparsity).astype(np.float32),
                        "R": (rng.random((16, 16)) >= sparsity).astype(np.float32),
                        "b": np.ones(16, np.float32)} for g in gates}
        masks_np["theta"] = np.ones(16, np.float32)
        masks_np["out"] = None
    jl = JSP.flat_layout(jcfg)
    jcl = JSP.col_layout(jl, masks_np)     # the host tables read numpy
    layout = SP.flat_layout(cfg)
    cl = SP.col_layout(layout, None if masks_np is None else
                       masks_from_numpy(masks_np, "cpu"), device="cpu")
    want = JCF.fused_segments(jl, jcl)
    got = CF.fused_segments(layout, cl)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:5] == w[:5]
        np.testing.assert_array_equal(g[5], w[5])
        np.testing.assert_array_equal(g[6], w[6])


# ---------------------------------------------------------------------------
# build plumbing (no nvcc here: only the parts that run without it)
# ---------------------------------------------------------------------------

def test_library_path_is_keyed_by_source_hash():
    p = _build.library_path("compact_fused")
    assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
    assert p.name.startswith("compact_fused-")
    assert p == _build.library_path("compact_fused")


def _fused_args_fields():
    """The field names of the packed launch buffer, in the order the C
    entry point reads them (`struct FusedArgs` in csrc/compact_fused.cu)."""
    import re
    src = (_build.CSRC / "compact_fused.cu").read_text()
    body = re.search(r"struct FusedArgs \{(.*?)\};", src, re.S).group(1)
    body = body.replace("unsigned long long", "")
    return [f.strip() for f in body.replace(";", "").split(",")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_call_packs_in_entry_point_order_and_raises(monkeypatch, dtype):
    """K1's launch route (`_build.KernelCall`) on CPU tensors, with the
    library and the device and stream lookups stubbed: the eight operand
    pointers, out, (B, n, K, Pc), the carry dtype and the stream packed as
    64-bit ints in the order of the C entry point's struct; a mis-shaped
    or misaligned operand raises before any launch."""
    import struct
    packed = []

    class Lib:
        @staticmethod
        def repro_fused_update(buf):
            packed.append(struct.unpack(f"{len(buf) // 8}Q", buf))
            return 0

        @staticmethod
        def repro_error_string(err):
            return b"bad launch"

    monkeypatch.setattr(_build, "load", lambda name: Lib)
    monkeypatch.setattr(_build, "_get_device", lambda: None)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 77)
    monkeypatch.setattr(CF, "_CALLS", {})
    monkeypatch.setattr(CF, "_last", [None])
    ops = _torch_args(_ragged_np(7, B=3, K=16, n=40, Pc_pad=128), dtype)
    B, K, Pc = ops[1].shape
    call = CF._call(B, 40, K, Pc, dtype, torch.device("cpu"))
    assert call.matches(ops) and CF._call(B, 40, K, Pc, dtype,
                                          torch.device("cpu")) is call
    CF._last[0] = call            # the CPU tensors now take the launch route
    before = CF.fused_update.launches
    out = CF.fused_update(*ops)
    assert CF.fused_update.launches == before + 1
    assert out.dtype == dtype and out.shape == ops[1].shape
    got = dict(zip(_fused_args_fields(), packed[-1], strict=True))
    names = ("J", "vals", "mbar", "hp", "idx_new", "idx_prev", "count_new",
             "count_prev")
    assert {k: got[k] for k in names} == {
        k: t.data_ptr() for k, t in zip(names, ops)}
    assert got["out"] == out.data_ptr()
    assert (got["B"], got["n"], got["K"], got["Pc"]) == (B, 40, K, Pc)
    assert got["bf16"] == int(dtype == torch.bfloat16)
    assert got["stream"] == 77
    bad = list(ops)
    bad[3] = torch.zeros((B, K + 1))
    assert not call.matches(bad)
    with pytest.raises(ValueError, match=r"hp_rows has shape \(3, 17\)"):
        call.check(bad)
    bad = list(ops)
    bad[2] = torch.zeros(ops[2].numel() + 1)[1:].view(ops[2].shape)
    CF._last[0] = call
    with pytest.raises(ValueError, match="16-byte aligned"):
        CF.fused_update(*bad)
    assert CF.fused_update.launches == before + 1


def test_every_launch_entry_takes_one_packed_buffer():
    """Every kernel launches through `KernelCall`: each exported launch
    function takes one packed buffer, and no source keeps a runtime
    `<<<>>>` launch."""
    import ctypes
    for name, fns in _build.SIGNATURES.items():
        launches = [f for f in fns
                    if not f.endswith(("_error_string", "_geometry"))]
        assert launches, name
        for f in launches:
            assert fns[f] == ([ctypes.c_char_p], ctypes.c_int), (name, f)
    for src in _build.CSRC.glob("*.cu"):
        assert "<<<" not in src.read_text(), src.name
