"""The port's chunked WKV (kernel K4's wrapper and plain version,
`repro_torch.kernels.wkv`) held against the JAX package on the same numpy
inputs: the Pallas kernel `wkv_pallas` in interpret mode, the chunk-scanned
`models.rwkv.wkv_full` (for a given initial state, which the Pallas kernel
does not take), and the sequential recurrence `kernels.ref.wkv_chunk_ref`
chained over the chunks.

Tolerances: against `wkv_pallas` and `wkv_full`, the same chunked algebra
in f32, within 1e-5 of the largest magnitude of the reference's result;
against the sequential recurrence, another order of the same sums over
the whole sequence, the reference's own 5e-4 (`tests/test_kernels.py`,
`test_wkv_pallas_kernel_matches_sequential`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as JREF
from repro.kernels.wkv import wkv_pallas
from repro.models import rwkv as JRW
from repro_torch.kernels import ref as REF, wkv as WK

REL = 1e-5


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _inputs(B, H, T, D, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, H, T, D))).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32)
    return r, k, v, logw, u


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _sequential(r, k, v, logw, u, L, S0=None):
    """The reference's exact recurrence, chunk after chunk."""
    B, H, T, D = r.shape
    S = jnp.zeros((B, H, D, D)) if S0 is None else jnp.asarray(S0)
    outs = []
    for c in range(T // L):
        sl = slice(c * L, (c + 1) * L)
        o, S = JREF.wkv_chunk_ref(*(jnp.asarray(a[:, :, sl]) for a in (r, k, v, logw)),
                                  jnp.asarray(u), S)
        outs.append(o)
    return jnp.concatenate(outs, axis=2), S


@pytest.mark.parametrize("T,D,L", [(32, 8, 8), (64, 16, 16), (64, 64, 16)])
def test_wkv_matches_pallas_kernel_and_sequential_state(T, D, L):
    arrays = _inputs(2, 3, T, D, seed=T + D + L)
    before = WK.wkv.launches
    o, S = WK.wkv(*_t(*arrays), chunk=L)
    assert WK.wkv.launches == before                  # CPU: no launch
    assert o.dtype == S.dtype == torch.float32
    _close(o, wkv_pallas(*map(jnp.asarray, arrays), chunk=L, interpret=True))
    o_seq, S_seq = _sequential(*arrays, L)
    _close(o, o_seq, rel=5e-4)
    _close(S, S_seq, rel=5e-4)


def test_wkv_bf16_inputs_match_pallas_kernel():
    r, k, v, logw, u = _inputs(2, 2, 32, 16, seed=9)
    rb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (r, k, v))
    o, _ = WK.wkv(rb, kb, vb, *_t(logw, u), chunk=8)
    want = wkv_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)),
                      jnp.asarray(logw), jnp.asarray(u), chunk=8, interpret=True)
    _close(o, want)


def test_wkv_with_initial_state_matches_reference_wkv_full():
    B, H, T, D, L = 2, 3, 48, 16, 16
    r, k, v, logw, u = _inputs(B, H, T, D, seed=4)
    S0 = np.random.default_rng(5).standard_normal((B, H, D, D)).astype(np.float32)
    o, S = WK.wkv(*_t(r, k, v, logw, u, S0), chunk=L)
    jcfg = jget_config("rwkv6-3b").replace(rwkv_chunk=L, remat="none",
                                           compute_dtype=jnp.float32)
    tr = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))
    jo, jS = JRW.wkv_full(jcfg, tr(r), tr(k), tr(v), tr(logw), jnp.asarray(u),
                          jnp.asarray(S0))
    _close(o, np.asarray(jo).transpose(0, 2, 1, 3))
    _close(S, jS)
    o_seq, S_seq = _sequential(r, k, v, logw, u, L, S0)
    _close(o, o_seq, rel=5e-4)
    _close(S, S_seq, rel=5e-4)


@pytest.mark.parametrize("ww", [10.0, -20.0])
def test_wkv_at_the_decay_clip_ends_matches_pallas_kernel(ww):
    """logw at both ends of decay_logw's clip: -e^10 (a decay that empties
    the state in one step) and -e^-20 (no decay at all)."""
    r, k, v, _, u = _inputs(1, 2, 32, 16, seed=6)
    logw = np.full(r.shape, -np.exp(ww), np.float32)
    o, S = WK.wkv(*_t(r, k, v, logw, u), chunk=16)
    assert bool(torch.isfinite(o).all() and torch.isfinite(S).all())
    _close(o, wkv_pallas(*map(jnp.asarray, (r, k, v, logw, u)), chunk=16,
                         interpret=True))
    _, S_seq = _sequential(r, k, v, logw, u, 16)
    _close(S, S_seq, rel=5e-4)


def test_wkv_chunk_and_sequential_oracle_match_reference():
    r, k, v, logw, u = _inputs(2, 3, 8, 16, seed=1)
    S0 = np.random.default_rng(2).standard_normal((2, 3, 16, 16)).astype(np.float32)
    for fn, jfn in ((WK.wkv_chunk, JRW.wkv_chunk),
                    (REF.wkv_chunk_ref, JREF.wkv_chunk_ref)):
        o, S = fn(*_t(r, k, v, logw, u, S0))
        jo, jS = jfn(*map(jnp.asarray, (r, k, v, logw, u, S0)))
        _close(o, jo)
        _close(S, jS)


def test_wkv_rejects_unaligned_sequences():
    arrays = _t(*_inputs(1, 2, 24, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        WK.wkv(*arrays, chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        WK.wkv_reference(*arrays, chunk=16)


def test_wkv_without_a_kernel_for_the_device_raises():
    """Only CPU tensors take the plain version: a tensor on a device with no
    kernel raises instead of falling back to it."""
    B, H, T, D = 1, 2, 16, 8
    ops = [torch.empty((B, H, T, D), device="meta") for _ in range(4)]
    before = WK.wkv.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        WK.wkv(*ops, torch.empty((H, D), device="meta"), chunk=8)
    assert WK.wkv.launches == before


def test_kernel_library_is_keyed_by_its_source_and_the_shared_headers(
        tmp_path, monkeypatch):
    """csrc/wkv.cu includes driver_launch.cuh: an edit to either names a new
    library, so a stale build is never loaded; an unchanged tree keeps its
    name."""
    import shutil

    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    base = _build.library_path("wkv")
    assert base == _build.library_path("wkv")
    assert base.name.startswith("wkv-") and base.suffix == ".so"
    (csrc / "driver_launch.cuh").write_text(
        (csrc / "driver_launch.cuh").read_text() + "\n// edited\n")
    after_header = _build.library_path("wkv")
    (csrc / "wkv.cu").write_text((csrc / "wkv.cu").read_text() + "\n")
    after_source = _build.library_path("wkv")
    assert len({base, after_header, after_source}) == 3
