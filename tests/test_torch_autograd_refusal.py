"""The port's kernel wrappers have no backward, so on the card they refuse
autograd; on the CPU they run the plain versions, which differentiate.

A CUDA wrapper fills outputs it allocated through ctypes, so they carry no
grad_fn: a loss through one would silently miss that part of its
gradient.  `_build.refuse_autograd`, which every CUDA branch calls before
its launch, raises instead, exactly when grad mode is on and an operand
requires grad.  The CUDA side of the rule (each wrapper raises, and runs
under torch.no_grad()) is `tests/test_torch_cuda.py::
test_kernel_wrappers_refuse_autograd`.

Tolerances: the port's CPU gradient of the chunked WKV against JAX's
gradient of the reference `models.rwkv.wkv_full` on the same numpy inputs,
within 1e-5 of each gradient's largest magnitude (the same chunked algebra
in f32, its sums associated differently); the wrapper on the CPU against
its plain version, exactly (the same code).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import rwkv as JRW
from repro_torch.kernels import _build, compact_fused as CF
from repro_torch.kernels import event_matmul as EM, influence as IN
from repro_torch.kernels import ops as OPS, wkv as WK

REL = 1e-5


@pytest.mark.parametrize("grad_mode", [True, False])
@pytest.mark.parametrize("requires_grad", [True, False])
@pytest.mark.parametrize("under_no_grad", [False, True])
def test_refuse_autograd_raises_exactly_in_grad_mode_with_a_grad_operand(
        grad_mode, requires_grad, under_no_grad):
    plain = torch.ones(3)
    op = torch.ones(3, requires_grad=requires_grad)
    block = torch.no_grad() if under_no_grad else contextlib.nullcontext()
    with torch.set_grad_enabled(grad_mode), block:
        if grad_mode and requires_grad and not under_no_grad:
            with pytest.raises(RuntimeError,
                               match=r"^k4: .*call under torch\.no_grad\(\) "
                                     r"or use the plain version"):
                _build.refuse_autograd("k4", plain, op)
        else:
            _build.refuse_autograd("k4", plain, op)


def test_refuse_autograd_passes_without_operands_and_inside_inference_mode():
    _build.refuse_autograd("k4")
    with torch.inference_mode():
        _build.refuse_autograd("k4", torch.ones(2))
    leaf = torch.ones(2, requires_grad=True)
    with torch.inference_mode():
        _build.refuse_autograd("k4", leaf)


def _wkv_inputs(B=2, H=2, T=32, D=16, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, H, T, D))).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32)
    S0 = rng.standard_normal((B, H, D, D)).astype(np.float32)
    w_o = rng.standard_normal((B, H, T, D)).astype(np.float32)
    w_S = rng.standard_normal((B, H, D, D)).astype(np.float32)
    return (r, k, v, logw, u, S0), (w_o, w_S)


def _torch_grads(fn, arrays, weights, chunk):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    o, S = fn(*leaves, chunk=chunk)
    assert o.requires_grad and S.requires_grad
    w_o, w_S = (torch.from_numpy(w) for w in weights)
    loss = (o * w_o).sum() + (S * w_S).sum()
    return torch.autograd.grad(loss, leaves)


def test_wkv_on_cpu_operands_that_require_grad_stays_differentiable():
    """The CPU branch keeps autograd: the wrapper's gradient is the plain
    version's, and both are JAX's gradient of the reference wkv_full."""
    arrays, weights = _wkv_inputs()
    L = 16
    before = WK.wkv.launches
    got = _torch_grads(WK.wkv, arrays, weights, L)
    assert WK.wkv.launches == before
    plain = _torch_grads(WK.wkv_reference, arrays, weights, L)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)

    jcfg = jget_config("rwkv6-3b").replace(rwkv_chunk=L, remat="none",
                                           compute_dtype=jnp.float32)
    tr = lambda a: a.transpose(0, 2, 1, 3)               # [B,H,T,D] <-> [B,T,H,D]
    w_o, w_S = map(jnp.asarray, weights)

    def loss(r, k, v, logw, u, S0):
        o, S = JRW.wkv_full(jcfg, tr(r), tr(k), tr(v), tr(logw), u, S0)
        return (tr(o) * w_o).sum() + (S * w_S).sum()

    want = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, arrays))
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=REL * scale)


def _cpu_case(name):
    """(wrapper, plain version, args, kwargs, index of the float operand
    made to require grad) on small CPU operands made from a seed."""
    rng = np.random.default_rng(1)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    if name == "fused_update":
        B, K, n, Pc = 2, 4, 6, 8
        idx = np.tile(np.arange(K, dtype=np.int32), (B, 1))
        counts = torch.tensor([K, 2], dtype=torch.int32)
        args = [t(rng.normal(size=(B, n, n))), t(rng.normal(size=(B, K, Pc))),
                t(rng.normal(size=(B, K, Pc))), t(rng.random((B, K))),
                torch.from_numpy(idx), torch.from_numpy(idx), counts, counts]
        return CF.fused_update, CF.fused_reference, args, {}, 1
    if name == "influence_update":
        B, n, P = 2, 16, 128
        ops = OPS.influence_operands(
            t(rng.random((B, n))), t(rng.normal(size=(B, n, n))),
            t(rng.normal(size=(B, n, P))), t(rng.normal(size=(B, n, P))))
        masks = dict(row_mask=ops[4], prev_mask=ops[5], col_mask=ops[6],
                     jmask=ops[7])
        return (IN.influence_update, IN.influence_reference, list(ops[:4]),
                masks, 2)
    a_p, R_p, act, rm = OPS.event_matmul_operands(
        t(rng.normal(size=(3, 16))), t(rng.normal(size=(16, 128))))
    return (EM.event_matmul, EM.event_matmul_reference, [a_p, R_p],
            dict(act_mask=act, rmask=rm), 1)


@pytest.mark.parametrize("name", ["fused_update", "influence_update",
                                  "event_matmul"])
def test_kernel_wrappers_on_cpu_keep_autograd(name):
    """K1-K3 on CPU operands that require grad: no refusal, no launch, a
    differentiable output and the plain version's gradient."""
    fn, plain, args, kwargs, i = _cpu_case(name)
    leaf = args[i].clone().requires_grad_(True)
    before = fn.launches
    out = fn(*args[:i], leaf, *args[i + 1:], **kwargs)
    assert fn.launches == before and out.requires_grad
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=tuple(out.shape)).astype(np.float32))
    (g,) = torch.autograd.grad((out.float() * w).sum(), leaf)
    leaf_p = args[i].clone().requires_grad_(True)
    ref = plain(*args[:i], leaf_p, *args[i + 1:], **kwargs)
    (g_p,) = torch.autograd.grad((ref.float() * w).sum(), leaf_p)
    assert torch.equal(g, g_p) and bool(g.abs().sum() > 0)
