"""The yardstick pinned by hand: the frozen counts, the reducer of the
trace, the traffic generator and the plain reference (a hand-worked step
and BPTT through the same surrogate).  CPU only; imports no JAX."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from bench import costs, generator, trace
from bench.systems import scaled_online as S

ref = S.load_reference("scaled_rnn_reference")

OPT = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.0}


# -- the counts ---------------------------------------------------------------

def test_k1_counts_by_hand():
    # two examples: K_b (2, 3), K'_b (1, 4), 10 columns, capacity 4
    assert costs.k1_flops([2, 3], [1, 4], 10) == 2 * 10 * (2 + 12) + 2 * 10 * 5
    # previous rows 5*10*4, M-bar rows 5*10*4, J 14*4, hp 5*4, index rows
    # 2*2*4*4, counts 2*2*4, the new carry 2*4*10*4
    assert costs.k1_bytes([2, 3], [1, 4], 10, 4) == (
        200 + 200 + 56 + 20 + 64 + 16 + 320)
    # a bf16 carry halves the carry's bytes only
    assert costs.k1_bytes([2, 3], [1, 4], 10, 4, carry_bytes=2) == (
        100 + 200 + 56 + 20 + 64 + 16 + 160)


def test_least_seconds_and_step_flops_by_hand():
    assert costs.least_seconds(495e12, 3.35e12) == (1.0, "operations")
    assert costs.least_seconds(495e12, 6.7e12) == (2.0, "bytes")
    # batch 2, n 3, n_in 4, n_out 5, rows (1, 2), 10 columns:
    # forward 2*2*3*7, readout 3 * 2*2*3*5, extraction 2*10*3
    assert costs.rnn_step_flops(2, 3, 4, 5, [1, 2], 10) == 84 + 180 + 60


def test_the_cells_k1_bound_is_bytes():
    # dense-act at K 1,024: 911 rows of 120,064 columns an example
    kb = [911] * 8
    f = costs.k1_flops(kb, kb, 120064)
    b = costs.k1_bytes(kb, kb, 120064, 1024)
    t, by = costs.least_seconds(f, b)
    assert by == "bytes" and 3.0e-3 < t < 3.6e-3


# -- the trace reduction ----------------------------------------------------------

def test_reduce_events_by_hand():
    ev = [(trace.SPAN, False, 0.0, 100.0),
          ("host_a", False, 0.0, 40.0), ("host_b", False, 10.0, 30.0),
          ("k1", True, 5.0, 15.0), ("k1", True, 12.0, 20.0),
          ("other", True, 60.0, 90.0), (trace.SPAN, True, 0.0, 100.0),
          ("late", True, 150.0, 160.0)]
    red = trace.reduce_events(ev)
    assert red["window_s"] == pytest.approx(100e-6)
    assert red["busy_s"] == pytest.approx((15 + 30) * 1e-6)
    assert red["ops"] == 3
    # gaps: [0, 5) in host_a; [20, 60) mid 40 in host_a (host_b ended at
    # 30); [90, 100) with no host op
    names = [g[0] for g in red["gaps"]]
    assert names == ["host_a", "host_a", trace.NO_HOST_OP]
    assert trace.kernel_seconds(red, "k1") == (pytest.approx(18e-6), 2)
    bd = trace.breakdown(red)
    assert bd["device_ops"][0] == ["other", pytest.approx(30e-6)]
    assert bd["idle_gaps"][0] == ["host_a", pytest.approx(45e-6)]


# -- the generator ------------------------------------------------------------

def test_stream_is_keyed_by_seed_and_step():
    mix = generator.load_mix("sparse-act")
    big = 2**31 + 987_654_321
    s1 = generator.make_stream(mix, seed=big, batch=8, n_in=128, n_classes=8)
    s2 = generator.make_stream(mix, seed=big, batch=8, n_in=128, n_classes=8)
    x5, y5 = s1(5)
    s1(0)
    x5b, y5b = s2(5)
    assert np.array_equal(x5, x5b) and np.array_equal(y5, y5b)
    assert not np.array_equal(x5, s1(6)[0])
    assert x5.dtype == np.float32 and x5.shape == (8, 128)
    assert 6.0 < float(x5.std()) < 10.0          # sigma 8
    assert y5.min() >= 0 and y5.max() < 8
    with pytest.raises(ValueError):
        generator.make_stream(dict(mix, loop="open"), seed=1, batch=1,
                              n_in=1, n_classes=2)


# -- the reference --------------------------------------------------------------

def test_tf32_rounding_by_hand():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12,
                      -(1.0 + 3 * 2**-11)], dtype=torch.float32)
    got = ref.tf32(x).tolist()
    assert got == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -(1.0 + 2**-9)]


def test_live_columns_order_by_hand():
    mW = torch.tensor([[1.0, 0.0]])                   # n_in 1, n 2
    mR = torch.tensor([[0.0, 1.0], [1.0, 1.0]])
    q, j = ref.live_columns(mW, mR)
    # unit 0: W[0,0], R[1,0], b, theta; unit 1: R[0,1], R[1,1], b, theta
    assert q.tolist() == [0, 0, 0, 0, 1, 1, 1, 1]
    assert j.tolist() == [0, 2, 3, 4, 1, 2, 3, 4]


def test_one_step_by_hand():
    # n 2, n_in 1, batch 1, one window of one step from a zero state
    p = {"W": torch.tensor([[0.5, -0.2]]), "R": torch.tensor([[0.3, 0.0],
                                                             [0.0, 0.4]]),
         "b": torch.tensor([0.0, 0.1]), "theta": torch.tensor([0.1, 0.1]),
         "out_W": torch.tensor([[1.0, -1.0], [0.5, 0.5]]),
         "out_b": torch.zeros(2)}
    masks = {"W": torch.ones(1, 2), "R": torch.ones(2, 2)}
    xs, ys = torch.tensor([[[0.4]]]), torch.tensor([[1]])
    r = ref.run(p, masks, xs, ys, k=1, windows=1, opt=OPT, gamma=1.0,
                eps=0.3)
    # v = (0.2 - 0.1, -0.08 + 0.1 - 0.1) = (0.1, -0.08); a = (1, 0)
    assert r["v"][0, 0].tolist() == pytest.approx([0.1, -0.08])
    assert r["spikes"][0, 0].tolist() == [1.0, 0.0]
    hp = [1 - 0.1 / 0.6, 1 - 0.08 / 0.6]
    # columns: unit 0 (W, R0, R1, b, theta), unit 1 the same; g = (x, a_prev
    # = 0, 0, 1, -1); M = hp_k [q == k] g_j
    want = torch.zeros(2, 10)
    want[0, :5] = hp[0] * torch.tensor([0.4, 0.0, 0.0, 1.0, -1.0])
    want[1, 5:] = hp[1] * torch.tensor([0.4, 0.0, 0.0, 1.0, -1.0])
    assert torch.allclose(r["carry"][0], want, atol=1e-7)
    logits = torch.tensor([1.0, -1.0])
    assert r["losses"][0] == pytest.approx(
        float(-torch.log_softmax(logits, 0)[1]), rel=1e-6)
    sm = torch.softmax(logits, 0)
    dlog = sm - torch.tensor([0.0, 1.0])
    cbar = p["out_W"] @ dlog                              # dL/da
    g = r["grad1"]
    assert float(g["W"][0, 0]) == pytest.approx(float(cbar[0]) * hp[0] * 0.4)
    assert float(g["theta"][1]) == pytest.approx(-float(cbar[1]) * hp[1])
    assert torch.allclose(g["out_W"], torch.outer(torch.tensor([1.0, 0.0]),
                                                  dlog))


class _Spike(torch.autograd.Function):
    """H(v) forward, the pseudo-derivative backward."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return (v > 0).float()

    @staticmethod
    def backward(ctx, grad):
        (v,) = ctx.saved_tensors
        return grad * torch.clamp(1.0 - v.abs() / 0.6, min=0.0)


def test_reference_gradient_is_bptt_through_the_surrogate():
    cfg = {"n": 24, "n_in": 8, "n_out": 4, "sparsity": 0.5, "mask_block": 4,
           "network_seed": 0}
    params, masks = S.draw(cfg, 7, "cpu")
    g = torch.Generator().manual_seed(3)
    xs = 2.0 * torch.randn(6, 3, 8, generator=g)
    ys = torch.randint(0, 4, (6, 3), generator=g)
    r = ref.run(params, masks, xs, ys, k=6, windows=1, opt=OPT, gamma=1.0,
                eps=0.3)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    a = torch.zeros(3, 24)
    loss = 0.0
    for t in range(6):
        v = xs[t] @ (p["W"] * masks["W"]) + a @ (p["R"] * masks["R"]) \
            + p["b"] - p["theta"]
        a = _Spike.apply(v)
        logits = a @ p["out_W"] + p["out_b"]
        loss = loss + torch.nn.functional.cross_entropy(logits, ys[t]) / 6
    grads = torch.autograd.grad(loss, list(p.values()))
    assert r["losses"][0] == pytest.approx(float(loss.detach()), rel=1e-6)
    for name, gb in zip(p, grads):
        gb = gb * masks[name] if name in masks else gb
        scale = float(gb.abs().max()) + 1e-12
        assert float((r["grad1"][name] - gb).abs().max()) / scale < 1e-5, name


def test_adamw_step_by_hand():
    p = {n: torch.zeros(1) for n in ref.LEAVES}
    p["W"] = torch.ones(1, 1)
    m1 = {n: torch.zeros_like(t) for n, t in p.items()}
    m2 = {n: torch.zeros_like(t) for n, t in p.items()}
    grads = {n: torch.full_like(t, 0.5) for n, t in p.items()}
    ref._adamw(p, m1, m2, grads, {"W": torch.zeros(1, 1)}, 0, OPT)
    # first step: m-hat = g, v-hat = g^2: the update is lr * g / (|g| + eps)
    assert float(p["b"]) == pytest.approx(-1e-3 * 0.5 / (0.5 + 1e-8))
    assert float(p["W"]) == 0.0                      # masked
    assert math.isclose(float(m1["b"]), 0.05, rel_tol=1e-6)
