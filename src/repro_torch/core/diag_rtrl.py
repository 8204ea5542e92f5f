"""Exact RTRL for diagonal (element-wise) recurrences, in PyTorch.

Counterpart of `repro.core.diag_rtrl`.  For cells of the form
h_t = a_t(x_t; w) * h_{t-1} + b_t(x_t; w) the Jacobian J_t = diag(a_t) is
diagonal, so the influence matrix factors into per-parameter eligibility
traces

    e_t[w] = a_t * e_{t-1}[w] + d(a_t)/dw * h_{t-1} + d(b_t)/dw

at O(p) a step instead of O(n^2 p), with no approximation.  This module
keeps the gate-free toy cell (no input gate); the RG-LRU recurrence with
its input gate is `repro_torch.cells.rglru`.  Both train through
`LearnerSpec(engine="diag_exact")` (`engine="diag"` is the same engine).

Parameters draw from a `torch.Generator` on the CPU (Wx, Wa, lam, then the
readout W), so a seed gives the same weights on every device; parity tests
hand both packages the same numpy arrays.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import bptt as BP
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class DiagCellConfig:
    n: int = 64                  # state width
    n_in: int = 32
    n_out: int = 4
    c: float = 8.0               # RG-LRU gate exponent


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the JAX package writes it (logaddexp(x, 0)), with no
    threshold above which x is returned as is."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _normal(gen, shape, scale):
    return scale * torch.randn(shape, generator=gen, dtype=torch.float32)


def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                       dtype=torch.float32)


def init_params(cfg: DiagCellConfig, gen: torch.Generator, *,
                device) -> dict:
    s = 1.0 / math.sqrt(cfg.n_in)
    p = {"Wx": _normal(gen, (cfg.n_in, cfg.n), s),          # input proj
         "Wa": _normal(gen, (cfg.n_in, cfg.n), s),          # gate proj
         "lam": _uniform(gen, (cfg.n,), 2.2, 5.5),
         "out": {"W": _normal(gen, (cfg.n, cfg.n_out), 1.0 / math.sqrt(cfg.n)),
                 "b": torch.zeros((cfg.n_out,))}}
    return tree_map(lambda t: t.to(device), p)


def gates(cfg: DiagCellConfig, params, x_t):
    """-> (a_t [B,n] in (0,1), b_t [B,n]) and the intermediates the traces
    read: (a, b, r, log_a, scale)."""
    r = torch.sigmoid(x_t @ params["Wa"])
    log_a = -cfg.c * r * softplus(params["lam"])
    a = torch.exp(log_a)
    scale = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-9))
    b = scale * (x_t @ params["Wx"])
    return a, b, r, log_a, scale


def step(cfg: DiagCellConfig, params, h, x_t):
    a, b, *_ = gates(cfg, params, x_t)
    return a * h + b


def init_traces(cfg: DiagCellConfig, batch: int, *, device) -> dict:
    """Eligibility traces e[w] = dh/dw, by diagonality: Wx[j, k] reaches
    h_k only -> [B, n_in, n]; the same for Wa; lam[k] -> [B, n]."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"Wx": torch.zeros((batch, cfg.n_in, cfg.n), **f32),
            "Wa": torch.zeros((batch, cfg.n_in, cfg.n), **f32),
            "lam": torch.zeros((batch, cfg.n), **f32)}


def cell_partials(cfg: DiagCellConfig, params, h_prev, x_t):
    """Closed-form (h_new, hp, a-diag [B,n], mbar): J_t = diag(a_t) and
    mbar[w] = dh_t/dw with h_{t-1} held fixed; `trace_update` is
    e <- a * e + mbar over these leaves."""
    a, b, r, log_a, scale = gates(cfg, params, x_t)
    sp = softplus(params["lam"])
    # d a / d (.) through log_a = -c * r * softplus(lam)
    dr = r * (1 - r)                                          # [B,n]
    da_dWa = a[:, None, :] * (-cfg.c * sp) * dr[:, None, :] * x_t[:, :, None]
    da_dlam = a * (-cfg.c * r) * torch.sigmoid(params["lam"])
    # b = scale(a) * (x Wx):  d scale / d a = -a / scale
    xw = x_t @ params["Wx"]
    dscale_da = -a / scale
    db_dWa = dscale_da[:, None, :] * da_dWa * xw[:, None, :]
    db_dlam = dscale_da * da_dlam * xw
    db_dWx = scale[:, None, :] * x_t[:, :, None]
    h_new = a * h_prev + b
    mbar = {"Wx": db_dWx,
            "Wa": da_dWa * h_prev[:, None, :] + db_dWa,
            "lam": da_dlam * h_prev + db_dlam}
    return h_new, torch.ones_like(a), a, mbar


def trace_update(cfg: DiagCellConfig, params, tr, h_prev, x_t):
    """Exact per-step trace propagation (J diagonal, so elementwise)."""
    h_new, _, a, mbar = cell_partials(cfg, params, h_prev, x_t)
    tr_new = {"Wx": a[:, None, :] * tr["Wx"] + mbar["Wx"],
              "Wa": a[:, None, :] * tr["Wa"] + mbar["Wa"],
              "lam": a * tr["lam"] + mbar["lam"]}
    return h_new, tr_new


def rtrl_loss_and_grads(cfg: DiagCellConfig, params, xs, labels):
    """Exact online RTRL for the diagonal cell, loss = mean_t CE(h_t W_out):
    the streaming learner (`core.learner.DiagLearner`) stepped over the
    whole sequence."""
    from repro_torch.core.learner import LearnerSpec, make_learner, scan_learner
    learner = make_learner(LearnerSpec(engine="diag", cfg=cfg))
    loss, grads, _ = scan_learner(learner, params, None, xs, labels)
    return loss, grads


def sequence_xent(hs: torch.Tensor, out: dict, labels: torch.Tensor):
    """mean over t and b of CE(h_t W + b, labels): hs [T, B, n], the label
    of each example fixed over the sequence (negative labels read as 0)."""
    logp = torch.log_softmax(hs @ out["W"] + out["b"], dim=-1)     # [T,B,o]
    lab = labels.clamp(min=0).long()[None, :, None].expand(hs.shape[0], -1, 1)
    return -logp.gather(2, lab).mean()


def bptt_loss_and_grads(cfg: DiagCellConfig, params, xs, labels):
    """Reference BPTT for the same cell and loss: (loss, grads)."""

    def loss_fn(p):
        h = torch.zeros((xs.shape[1], cfg.n), dtype=torch.float32,
                        device=xs.device)
        hs = []
        for x_t in xs:
            h = step(cfg, p, h, x_t)
            hs.append(h)
        return sequence_xent(torch.stack(hs), p["out"], labels), {}

    loss, grads, _ = BP._loss_and_grads(loss_fn, params)
    return loss, grads
