"""LIF / adaptive-threshold spiking cell with an e-prop learner surface, in
PyTorch.

Counterpart of `repro.cells.snn`.  The cell (Bellec et al.'s ALIF;
beta_a = 0 gives plain LIF):

    v_t = alpha v_{t-1} + x_t W + z_{t-1} R - v_th z_{t-1}   (soft reset)
    b_t = rho b_{t-1} + z_{t-1}                              (adaptation)
    z_t = H(v_t - A_t),   A_t = v_th + beta_a b_t
    psi_t = (gamma / v_th) max(0, 1 - |v_t - A_t| / v_th)    (surrogate)

e-prop keeps only the implicit recurrence through the membrane and drops
the explicit spike recurrence through R (an approximation, measured
against the surrogate-gradient BPTT oracle by cosine alignment):

    eps_v_t[j]    = alpha eps_v_{t-1}[j] + inp_t[j]              (rank-1)
    eps_a_t[j,k]  = psi_{t-1,k} eps_v_{t-1}[j]
                    + (rho - psi_{t-1,k} beta_a) eps_a_{t-1}[j,k]
    e_t[j,k]      = psi_t[k] (eps_v_t[j] - beta_a eps_a_t[j,k])
    dE/dw[j,k]   += L_t[k] e_t[j,k]

with the learning signal L_t = dL_t/dz_t broadcast exactly from the
readout.  `engine="eprop"` (`core.learner.EpropLearner`) carries this.

Parameters draw from a `torch.Generator` on the CPU (W, R, the readout W),
not from `jax.random`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import bptt as BP
from repro_torch.core.diag_rtrl import _normal, sequence_xent
from repro_torch.tree import tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    n: int = 64                  # neurons
    n_in: int = 32
    n_out: int = 4
    alpha: float = 0.9           # membrane decay
    rho: float = 0.97            # threshold-adaptation decay
    beta_a: float = 0.5          # adaptation coupling (0 -> plain LIF)
    v_th: float = 0.6
    gamma: float = 0.3           # surrogate-derivative height

    def replace(self, **kw) -> "SNNConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_rec_params(self) -> int:
        return self.n_in * self.n + self.n * self.n


def init_params(cfg: SNNConfig, gen: torch.Generator, *, device) -> dict:
    p = {"W": _normal(gen, (cfg.n_in, cfg.n), 1.0 / math.sqrt(cfg.n_in)),
         "R": _normal(gen, (cfg.n, cfg.n), 1.0 / math.sqrt(cfg.n)),
         "out": {"W": _normal(gen, (cfg.n, cfg.n_out), 1.0 / math.sqrt(cfg.n)),
                 "b": torch.zeros((cfg.n_out,))}}
    return tree_map(lambda t: t.to(device), p)


def pseudo_derivative(cfg: SNNConfig, u: torch.Tensor) -> torch.Tensor:
    """psi(v - A): the piecewise-linear surrogate, gamma-scaled."""
    return _psi(u, cfg.gamma, cfg.v_th)


def _psi(u, gamma, v_th):
    return (gamma / v_th) * torch.clamp(1.0 - u.abs() / v_th, min=0.0)


def init_state(cfg: SNNConfig, batch: int, *, device) -> dict:
    z = lambda: torch.zeros((batch, cfg.n), dtype=torch.float32,
                            device=device)
    return {"v": z(), "z": z(), "b": z(), "psi": z()}


def membrane(cfg: SNNConfig, params, state, x_t):
    """-> (v_new, b_new, A): the pre-spike dynamics the e-prop step and the
    surrogate-BPTT step share."""
    v_new = (cfg.alpha * state["v"] + x_t @ params["W"]
             + state["z"] @ params["R"] - cfg.v_th * state["z"])
    b_new = cfg.rho * state["b"] + state["z"]
    A = cfg.v_th + cfg.beta_a * b_new
    return v_new, b_new, A


class _SpikeST(torch.autograd.Function):
    """Heaviside forward, psi(u) in the backward pass (the JAX package's
    custom_jvp).  In the `setup_context` form with a generated vmap rule,
    so that `torch.func` transforms go through it as autograd does."""

    generate_vmap_rule = True

    @staticmethod
    def forward(u, gamma, v_th):
        return (u > 0.0).to(u.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, gamma, v_th = inputs
        ctx.save_for_backward(u)
        ctx.gamma, ctx.v_th = gamma, v_th

    @staticmethod
    def backward(ctx, grad):
        (u,) = ctx.saved_tensors
        return _psi(u, ctx.gamma, ctx.v_th) * grad, None, None


def step_st(cfg: SNNConfig, params, state, x_t) -> dict:
    """Autograd-able step: Heaviside forward, psi in the backward pass —
    the surrogate gradient the BPTT oracle differentiates."""
    v_new, b_new, A = membrane(cfg, params, state, x_t)
    u = v_new - A
    return {"v": v_new, "z": _SpikeST.apply(u, cfg.gamma, cfg.v_th),
            "b": b_new, "psi": pseudo_derivative(cfg, u)}


def init_eprop_traces(cfg: SNNConfig, batch: int, *, device) -> dict:
    """{"v_in" [B, n_in], "v_rec" [B, n]}: the rank-1 membrane traces, and
    the full [B, j, n] adaptation traces: the whole e-prop state."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"v_in": torch.zeros((batch, cfg.n_in), **f32),
            "v_rec": torch.zeros((batch, cfg.n), **f32),
            "a_in": torch.zeros((batch, cfg.n_in, cfg.n), **f32),
            "a_rec": torch.zeros((batch, cfg.n, cfg.n), **f32)}


def eprop_step(cfg: SNNConfig, params, state, tr, x_t):
    """One e-prop step -> (state_new, tr_new, e), e = {"W": [B, n_in, n],
    "R": [B, n, n]} this step's eligibility traces (contract them with the
    learning signal for the gradient term)."""
    v_new, b_new, A = membrane(cfg, params, state, x_t)
    u = v_new - A
    z_new = (u > 0.0).to(v_new.dtype)
    psi_new = pseudo_derivative(cfg, u)
    psi_prev = state["psi"]
    # the adaptation traces first: they read the previous membrane traces
    decay = cfg.rho - psi_prev * cfg.beta_a                    # [B,n]
    a_in = (psi_prev[:, None, :] * tr["v_in"][:, :, None]
            + decay[:, None, :] * tr["a_in"])
    a_rec = (psi_prev[:, None, :] * tr["v_rec"][:, :, None]
             + decay[:, None, :] * tr["a_rec"])
    v_in = cfg.alpha * tr["v_in"] + x_t
    v_rec = cfg.alpha * tr["v_rec"] + state["z"]
    e = {"W": psi_new[:, None, :] * (v_in[:, :, None] - cfg.beta_a * a_in),
         "R": psi_new[:, None, :] * (v_rec[:, :, None] - cfg.beta_a * a_rec)}
    state_new = {"v": v_new, "z": z_new, "b": b_new, "psi": psi_new}
    tr_new = {"v_in": v_in, "v_rec": v_rec, "a_in": a_in, "a_rec": a_rec}
    return state_new, tr_new, e


def bptt_loss_and_grads(cfg: SNNConfig, params, xs, labels):
    """Exact surrogate-gradient BPTT oracle (reverse through the full spike
    recurrence), loss = mean_t CE(z_t W_out + b, labels): (loss, grads)."""

    def loss_fn(p):
        state = init_state(cfg, xs.shape[1], device=xs.device)
        zs = []
        for x_t in xs:
            state = step_st(cfg, p, state, x_t)
            zs.append(state["z"])
        return sequence_xent(torch.stack(zs), p["out"], labels), {}

    loss, grads, _ = BP._loss_and_grads(loss_fn, params)
    return loss, grads


class SNNCell:
    """ALIF behind the cell protocol.  jac_kind "dense" (the true Jacobian
    is dense through R), but its state is the structured (v, z, b, psi):
    the SNN learns through `engine="eprop"`, which calls `eprop_step`
    instead of `partials`."""

    name = "snn"
    jac_kind = "dense"

    def __init__(self, cfg: SNNConfig):
        self.cfg = cfg

    def init_params(self, gen: torch.Generator, *, device) -> Tree:
        return init_params(self.cfg, gen, device=device)

    def rec_params(self, params: Tree) -> Tree:
        return {k: v for k, v in params.items() if k != "out"}

    def init_state(self, batch: int, *, device) -> dict:
        return init_state(self.cfg, batch, device=device)

    def init_traces(self, batch: int, *, device) -> dict:
        return init_eprop_traces(self.cfg, batch, device=device)

    def partials(self, w, state, x_t):
        raise NotImplementedError(
            "the SNN's structured (v, z, b) state has no flat closed-form "
            "partials — train it with LearnerSpec(engine='eprop'), which "
            "dispatches through eprop_step")

    def eprop_step(self, w: Tree, state: dict, tr: dict, x_t: torch.Tensor):
        return eprop_step(self.cfg, w, state, tr, x_t)

    def step_st(self, w: Tree, state: dict, x_t: torch.Tensor) -> dict:
        return step_st(self.cfg, w, state, x_t)

    def readout(self, params: Tree, state_or_z) -> torch.Tensor:
        z = state_or_z["z"] if isinstance(state_or_z, dict) else state_or_z
        return z @ params["out"]["W"] + params["out"]["b"]

    def activity_mask(self, state_or_z) -> torch.Tensor:
        z = state_or_z["z"] if isinstance(state_or_z, dict) else state_or_z
        return z != 0.0
