"""RG-LRU as a zoo cell, in PyTorch: diagonal recurrence, exact O(n p) RTRL.

Counterpart of `repro.cells.rglru`.  The Griffin / RecurrentGemma
recurrence

    r_t = sigmoid(x_t Wa)          i_t = sigmoid(x_t Wi)
    a_t = exp(-c r_t softplus(lam))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * (x_t Wx))

has a diagonal state Jacobian J_t = diag(a_t), so the influence recursion
factors into independent per-parameter eligibility traces

    e_t[w] = a_t * e_{t-1}[w] + dh_t/dw |_{h_{t-1} fixed}

(O(n_in n) trace memory, no [B, K, P] influence buffer and no n^2 factor).
`engine="diag_exact"` (`core.learner.DiagExactLearner`) carries exactly
this; its gradients are exact (held against `bptt_loss_and_grads`).

:class:`DiagCell` puts the toy diagonal cell (`core.diag_rtrl`, no input
gate) behind the same protocol, for `engine="diag"`.

Parameters and masks draw from `torch.Generator`s on the CPU, not from
`jax.random`: parity tests hand both packages the same numpy arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import bptt as BP, diag_rtrl as D
from repro_torch.core.diag_rtrl import softplus
from repro_torch.tree import tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class RGLRUCellConfig:
    n: int = 64                  # state width
    n_in: int = 32
    n_out: int = 4
    c: float = 8.0               # recurrence-gate exponent (Griffin)

    def replace(self, **kw) -> "RGLRUCellConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_rec_params(self) -> int:
        return 3 * self.n_in * self.n + self.n


def init_params(cfg: RGLRUCellConfig, gen: torch.Generator, *,
                device) -> dict:
    """Draws, in order: Wx, Wa, Wi, lam (uniform in [2.2, 5.5]), the
    readout W."""
    s = 1.0 / math.sqrt(cfg.n_in)
    p = {"Wx": D._normal(gen, (cfg.n_in, cfg.n), s),      # input proj
         "Wa": D._normal(gen, (cfg.n_in, cfg.n), s),      # recurrence gate
         "Wi": D._normal(gen, (cfg.n_in, cfg.n), s),      # input gate
         "lam": D._uniform(gen, (cfg.n,), 2.2, 5.5),
         "out": {"W": D._normal(gen, (cfg.n, cfg.n_out),
                                1.0 / math.sqrt(cfg.n)),
                 "b": torch.zeros((cfg.n_out,))}}
    return tree_map(lambda t: t.to(device), p)


def gates(cfg: RGLRUCellConfig, params, x_t):
    """-> (a, scale, i, r, xw): everything the step and the traces share."""
    r = torch.sigmoid(x_t @ params["Wa"])
    i = torch.sigmoid(x_t @ params["Wi"])
    a = torch.exp(-cfg.c * r * softplus(params["lam"]))
    scale = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-9))
    xw = x_t @ params["Wx"]
    return a, scale, i, r, xw


def step(cfg: RGLRUCellConfig, params, h, x_t):
    """Plain autograd-able step: what the BPTT oracle differentiates."""
    a, scale, i, _, xw = gates(cfg, params, x_t)
    return a * h + scale * (i * xw)


def cell_partials(cfg: RGLRUCellConfig, params, h_prev, x_t):
    """Closed-form (h_new, hp, a-diag [B,n], mbar): J_t = diag(a_t) and
    mbar[w] = dh_t/dw with h_{t-1} held fixed, one leaf per recurrent
    parameter tensor with the state axis n trailing."""
    r = torch.sigmoid(x_t @ params["Wa"])
    i = torch.sigmoid(x_t @ params["Wi"])
    sp = softplus(params["lam"])
    a = torch.exp(-cfg.c * r * sp)
    scale = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-9))
    xw = x_t @ params["Wx"]
    xb = i * xw
    h_new = a * h_prev + scale * xb
    # through the gate a: dh/da = h_prev + (dscale/da) xb, dscale/da =
    # -a / scale
    ha = h_prev + (-a / scale) * xb                            # [B,n]
    dr = r * (1.0 - r)
    da_dWa = a * (-cfg.c * sp) * dr                            # coef on x_j
    da_dlam = a * (-cfg.c * r) * torch.sigmoid(params["lam"])  # softplus'
    di = i * (1.0 - i)
    xj = x_t[:, :, None]
    mbar = {"Wx": (scale * i)[:, None, :] * xj,
            "Wi": (scale * xw * di)[:, None, :] * xj,
            "Wa": (ha * da_dWa)[:, None, :] * xj,
            "lam": ha * da_dlam}
    hp = torch.ones_like(a)     # no activity gate: every row live
    return h_new, hp, a, mbar


def init_traces(cfg: RGLRUCellConfig, batch: int, *, device) -> dict:
    """e[w] = dh/dw: [B, n_in, n] a projection, [B, n] for lam."""
    f32 = dict(dtype=torch.float32, device=device)
    z = lambda: torch.zeros((batch, cfg.n_in, cfg.n), **f32)
    return {"Wx": z(), "Wi": z(), "Wa": z(),
            "lam": torch.zeros((batch, cfg.n), **f32)}


def make_masks(cfg: RGLRUCellConfig, gen: torch.Generator, sparsity: float,
               *, device) -> dict:
    """Fixed masks over the projections, density (1 - sparsity), uniforms
    drawn from `gen` for Wx, Wi, Wa in that order; lam stays dense, as
    the EGRU biases and thresholds do."""
    def bern():
        u = torch.rand((cfg.n_in, cfg.n), generator=gen)
        return (u >= sparsity).float().to(device)
    masks = {"Wx": bern(), "Wi": bern(), "Wa": bern()}
    masks["lam"] = torch.ones((cfg.n,), device=device)
    return masks


def apply_masks(params: dict, masks: dict) -> dict:
    out = dict(params)
    for k, m in masks.items():
        out[k] = params[k] * m
    return out


def bptt_loss_and_grads(cfg: RGLRUCellConfig, params, xs, labels):
    """Reverse-mode BPTT oracle, loss = mean_t CE(h_t W_out + b, labels):
    (loss, grads)."""

    def loss_fn(p):
        h = torch.zeros((xs.shape[1], cfg.n), dtype=torch.float32,
                        device=xs.device)
        hs = []
        for x_t in xs:
            h = step(cfg, p, h, x_t)
            hs.append(h)
        return D.sequence_xent(torch.stack(hs), p["out"], labels), {}

    loss, grads, _ = BP._loss_and_grads(loss_fn, params)
    return loss, grads


class _DiagonalCell:
    """The protocol methods the two diagonal cells share: readout h W + b,
    a flat [B, n] state, every parameter but the readout recurrent."""

    jac_kind = "diagonal"

    def __init__(self, cfg):
        self.cfg = cfg

    def rec_params(self, params: Tree) -> Tree:
        return {k: v for k, v in params.items() if k != "out"}

    def init_state(self, batch: int, *, device) -> torch.Tensor:
        return torch.zeros((batch, self.cfg.n), dtype=torch.float32,
                           device=device)

    def readout(self, params: Tree, h: torch.Tensor) -> torch.Tensor:
        return h @ params["out"]["W"] + params["out"]["b"]

    def activity_mask(self, h: torch.Tensor) -> torch.Tensor:
        return h != 0.0


class RGLRUCell(_DiagonalCell):
    """RG-LRU behind the cell protocol: jac_kind "diagonal", so the third
    `partials` output is the diagonal a_t [B, n], and mbar is the
    per-parameter trace increment tree."""

    name = "rglru"

    def init_params(self, gen: torch.Generator, *, device) -> Tree:
        return init_params(self.cfg, gen, device=device)

    def init_traces(self, batch: int, *, device) -> Tree:
        return init_traces(self.cfg, batch, device=device)

    def partials(self, w: Tree, h_prev: torch.Tensor, x_t: torch.Tensor):
        return cell_partials(self.cfg, w, h_prev, x_t)

    def step_st(self, w: Tree, h_prev: torch.Tensor, x_t: torch.Tensor):
        return step(self.cfg, w, h_prev, x_t)


class DiagCell(_DiagonalCell):
    """The toy diagonal cell (`core.diag_rtrl`, no input gate) behind the
    same protocol: `engine="diag"` dispatches through it."""

    name = "diag"

    def init_params(self, gen: torch.Generator, *, device) -> Tree:
        return D.init_params(self.cfg, gen, device=device)

    def init_traces(self, batch: int, *, device) -> Tree:
        return D.init_traces(self.cfg, batch, device=device)

    def partials(self, w: Tree, h_prev: torch.Tensor, x_t: torch.Tensor):
        return D.cell_partials(self.cfg, w, h_prev, x_t)

    def step_st(self, w: Tree, h_prev: torch.Tensor, x_t: torch.Tensor):
        return D.step(self.cfg, w, h_prev, x_t)
