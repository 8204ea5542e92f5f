"""EGRU/ERNN closed-form per-step partials, in PyTorch.

Counterpart of `repro.cells.egru`.  Exploiting the paper's Eqs. (6)-(10):

  * J_t    = D(H'(v_t)) . J-hat_t          -> beta_t . n rows exactly zero
  * Mbar_t = D(H'(v_t)) . (per-unit groups) -> same rows zero; one parameter
    group (W[:,k'], R[:,k'], b_k' [, theta_k']) per unit k'.

`cell_partials_full` adds the input Jacobian B-hat = dv/dx: the
cross-layer injection of a stacked network, where layer l's input is the
layer below's activity (`core.stacked_rtrl`).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import cells
from repro_torch.core.cells import EGRUConfig

Tree = Any


def _gru_forward(w, a, x):
    mm = cells.slot_mm
    u = torch.sigmoid(mm(x, w["u"]["W"]) + mm(a, w["u"]["R"]) + w["u"]["b"])
    r = torch.sigmoid(mm(x, w["r"]["W"]) + mm(a, w["r"]["R"]) + w["r"]["b"])
    z = torch.tanh(mm(x, w["z"]["W"]) + mm(r * a, w["z"]["R"]) + w["z"]["b"])
    v = u * z + (1.0 - u) * a - w["theta"]
    return v, (u, r, z)


def cell_partials(cfg: EGRUConfig, w: Tree, a_prev: torch.Tensor,
                  x_t: torch.Tensor):
    """Closed-form (a_new, hp, J-hat [B,n,n], Mbar pieces).

    J = D(hp) @ J-hat;  Mbar rows are D(hp)-gated by construction."""
    a_new, hp, Jhat, _, mbar = _cell_partials_impl(cfg, w, a_prev, x_t,
                                                   False)
    return a_new, hp, Jhat, mbar


def cell_partials_full(cfg: EGRUConfig, w: Tree, a_prev: torch.Tensor,
                       x_t: torch.Tensor):
    """cell_partials plus the INPUT Jacobian B-hat [B, n, n_in] = dv/dx
    (hp-ungated): (a_new, hp, J-hat, B-hat, Mbar pieces).  For kind="rnn"
    B-hat is W^T, broadcast over the batch."""
    return _cell_partials_impl(cfg, w, a_prev, x_t, True)


def _cell_partials_impl(cfg: EGRUConfig, w: Tree, a_prev: torch.Tensor,
                        x_t: torch.Tensor, want_input_jac: bool):
    B, n = a_prev.shape
    ones = a_prev.new_ones((B, 1))
    if cfg.kind == "rnn":
        v = (cells.slot_mm(x_t, w["v"]["W"]) + cells.slot_mm(a_prev, w["v"]["R"])
             + w["v"]["b"] - w["theta"])
        a_new, hp = _activation(cfg, v)
        Jhat = w["v"]["R"].T[None].expand(B, n, n)
        # group vector g = (x, a_prev, 1, -1): diag Mbar coefficient = 1
        g = torch.cat([x_t, a_prev, ones, -ones], dim=1)
        mbar = {"v_diag_coef": a_prev.new_ones((B, n)), "v_g": g}
        Bhat = None
        if want_input_jac:
            Bhat = w["v"]["W"].T[None].expand(B, n, x_t.shape[1])
        return a_new, hp, Jhat, Bhat, mbar

    v, (u, r, z) = _gru_forward(w, a_prev, x_t)
    a_new, hp = _activation(cfg, v)
    du = u * (1 - u)
    dr = r * (1 - r)
    dz = 1 - z.square()
    cu = (z - a_prev) * du                     # coef on R_u^T rows
    cz = u * dz                                # coef on z-path rows
    Ru, Rr, Rz = w["u"]["R"], w["r"]["R"], w["z"]["R"]
    term_u = cu[:, :, None] * Ru.T[None]                        # [b,k,l]
    term_z1 = cz[:, :, None] * (r[:, None, :] * Rz.T[None])
    inner = torch.einsum("lm,bm,mk->blk", Rr, a_prev * dr, Rz)
    term_z2 = cz[:, :, None] * inner.transpose(1, 2)
    Jhat = term_u + term_z1 + term_z2
    diag = torch.arange(n, device=a_prev.device)
    Jhat[:, diag, diag] += 1 - u
    g_u = torch.cat([x_t, a_prev, ones], dim=1)
    g_z = torch.cat([x_t, r * a_prev, ones], dim=1)
    # r-gate coupling: dv_k/dw_r[k'] = cz_k R_z[k',k] a_{k'} dr_{k'} * g_r
    coef_r = cz[:, :, None] * Rz.T[None] * (a_prev * dr)[:, None, :]
    mbar = {"u_diag_coef": cu, "u_g": g_u,
            "z_diag_coef": cz, "z_g": g_z,
            "r_coef": coef_r, "r_g": g_u}
    Bhat = None
    if want_input_jac:
        # dv_k/dx_i = cu_k Wu[i,k] + cz_k (Wz[i,k] + sum_q Rz[q,k] a_q dr_q Wr[i,q])
        Wu, Wr, Wz = w["u"]["W"], w["r"]["W"], w["z"]["W"]
        inner_x = torch.einsum("iq,bq,qk->bik", Wr, a_prev * dr, Rz)
        Bhat = (cu[:, :, None] * Wu.T[None] + cz[:, :, None] * Wz.T[None]
                + cz[:, :, None] * inner_x.transpose(1, 2))
    return a_new, hp, Jhat, Bhat, mbar


def _activation(cfg: EGRUConfig, v):
    if cfg.dense:
        a = torch.tanh(v)
        return a, 1.0 - a.square()
    return cells.heaviside(v), cells.pseudo_derivative(v, cfg)


class EGRUCell:
    """The paper's EGRU/ERNN behind the cell protocol of `repro.cells`
    (jac_kind="dense": partials yield a [B, n, n] J-hat)."""

    name = "egru"
    jac_kind = "dense"

    def __init__(self, cfg: EGRUConfig):
        self.cfg = cfg

    def init_params(self, gen: torch.Generator, *, device) -> Tree:
        return cells.init_params(self.cfg, gen, device=device)

    def rec_params(self, params: Tree) -> Tree:
        return cells.rec_param_tree(params)

    def init_state(self, batch: int, *, device) -> torch.Tensor:
        return cells.init_state(self.cfg, batch, device=device)

    def partials(self, w: Tree, a_prev: torch.Tensor, x_t: torch.Tensor):
        """-> (a_new, hp, J-hat [B,n,n], mbar pieces)."""
        return cell_partials(self.cfg, w, a_prev, x_t)

    def partials_full(self, w: Tree, a_prev: torch.Tensor,
                      x_t: torch.Tensor):
        """-> (a_new, hp, J-hat, B-hat [B,n,n_in], mbar pieces)."""
        return cell_partials_full(self.cfg, w, a_prev, x_t)

    def step_st(self, w: Tree, a_prev: torch.Tensor, x_t: torch.Tensor):
        """Autograd-able forward (the shared surrogate gradient): what the
        BPTT oracles differentiate."""
        return cells.step_straight_through(self.cfg, w, a_prev, x_t)

    def readout(self, params: Tree, a: torch.Tensor) -> torch.Tensor:
        return cells.readout(params, a)

    def activity_mask(self, a: torch.Tensor) -> torch.Tensor:
        """Active (event-emitting) units this step."""
        return a != 0.0
