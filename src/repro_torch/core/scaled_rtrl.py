"""Sparse RTRL at scale (n in the thousands), in PyTorch: the paper's
Sec. 7 outlook.

Counterpart of `repro.core.scaled_rtrl`.  A thresholded RNN (kind "rnn")
of width n carries its influence ROW-COMPACT in the flat layout
(`sparse_rtrl.FlatLayout`): values [B, K, P_pad] plus the active-row
indices, K = the static capacity ceil(beta_capacity * n) rounded up to 8,
so the memory realises the paper's beta~ n p factor.  With the fixed masks
the parameter axis is also carried column-compact (`cfg.col_layout`,
[B, K, Pc_pad], Pc ~= w~ P): the combined w~ beta~ n p row of Table 1.

Every step is the engine the EGRU's compact backends run:
`sparse_rtrl.flat_compact_step` (backend "compact": J-hat = R^T tiles
looked up from R, one batched product) or
`sparse_rtrl.flat_compact_fused_step` (backend "compact_fused": one launch
of the hand-written CUDA kernel `kernels.compact_fused` a step), and for a
stack `stacked_rtrl.stacked_compact_step` (one a layer).  The gradient
c-bar^T M is read off the compact form (`kernels.compact.compact_grads`).

Sharding (`sharded_step_specs`): the batch over 'data' ('pod', 'data'
with a pod axis), the carry's parameter-column axis over 'model'.  The
contraction sum_l J[k, l] M[l, p] has no cross-p reduction, so each rank
runs the same step on its own columns (the learner's sharded carry,
`core.learner.ScaledLearner.place`): one K1 launch a layer a step on its
column shard and ZERO collectives in the influence update; the gradient
is reduced once an update (`ScaledLearner.grads`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.cells.egru import cell_partials
from repro_torch.core import cells, sparse_rtrl as SP, stacked_rtrl as ST
from repro_torch.core.cells import EGRUConfig, StackedEGRUConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import compact as CK
from repro_torch.models.module import NamedSharding, mesh_shape

Tree = Any


@dataclasses.dataclass(frozen=True)
class ScaledRTRLConfig:
    n: int = 1024
    n_in: int = 128
    n_out: int = 8
    batch: int = 8
    n_layers: int = 1               # > 1: stacked network, equal widths
    beta_capacity: float = 0.5      # K = ceil(beta_capacity * n), static
    sparsity: float = 0.9           # parameter sparsity (block mask)
    mask_block: int = 8
    gamma: float = 1.0
    eps: float = 0.3

    @property
    def K(self) -> int:
        """The reference's capacity: ceil(beta_capacity * n) rounded up to
        a multiple of 8, neither capped at n nor floored at 8 (unlike
        `sparse_rtrl.capacity_K`)."""
        return -(-int(math.ceil(self.beta_capacity * self.n)) // 8) * 8

    @property
    def m(self) -> int:
        return self.n_in + self.n + 2          # W col, R col, b, theta

    def cell_cfg(self) -> EGRUConfig:
        return EGRUConfig(n_hidden=self.n, n_in=self.n_in, n_out=self.n_out,
                          kind="rnn", gamma=self.gamma, eps=self.eps)

    def stacked_cfg(self) -> StackedEGRUConfig:
        return cells.stacked_config(self.cell_cfg(), self.n_layers)

    def layout(self) -> SP.FlatLayout:
        return SP.flat_layout(self.cell_cfg())

    def slayout(self) -> ST.StackedFlatLayout:
        return ST.stacked_layout(self.stacked_cfg())

    def col_layout(self, masks, *, device) -> SP.ColLayout:
        """Static live-column map from the fixed masks (one layer's, or the
        stacked axis shared by every layer): the carry shrinks to
        [B, K, Pc_pad], Pc ~= w~ P."""
        if self.n_layers > 1:
            return ST.stacked_col_layout(self.slayout(), masks, device=device)
        return SP.col_layout(self.layout(), masks, device=device)


def init_params(cfg: ScaledRTRLConfig, gen: torch.Generator, *,
                device: torch.device | str | None = None):
    """(params, masks): the cell's parameters drawn from `gen` (on the
    CPU), then the block masks (`cfg.mask_block`) from the same generator,
    the parameters masked.  `device` defaults to the card."""
    device = resolve_device(device)
    if cfg.n_layers > 1:
        scfg = cfg.stacked_cfg()
        params = cells.init_stacked_params(scfg, gen, device=device)
        masks = ST.make_stacked_masks(scfg, gen, cfg.sparsity, device=device,
                                      block=cfg.mask_block)
        return ST.apply_stacked_masks(params, masks), masks
    params = cells.init_params(cfg.cell_cfg(), gen, device=device)
    masks = SP.make_masks(cfg.cell_cfg(), gen, cfg.sparsity, device=device,
                          block=cfg.mask_block)
    return SP.apply_masks(params, masks), masks


# ---------------------------------------------------------------------------
# Compact influence state: [B, K, P_carry] (P_carry = Pc_pad or P_pad)
# ---------------------------------------------------------------------------

def init_state(cfg: ScaledRTRLConfig, cl: SP.ColLayout | None = None,
               influence_dtype: str = "float32", *,
               device: torch.device | str | None = None) -> dict:
    """{"a", "vals", "idx"}, one tensor each or a tuple a layer.  With `cl`
    the carry's parameter axis is Pc_pad wide; a "bfloat16" carry stores
    half the bytes (every contraction accumulates in f32)."""
    device = resolve_device(device)
    B, K, n = cfg.batch, cfg.K, cfg.n
    vdt = SP.influence_carry_dtype(influence_dtype)
    f32 = dict(dtype=torch.float32, device=device)

    def one(P_carry):
        return (torch.zeros((B, n), **f32),
                torch.zeros((B, K, P_carry), dtype=vdt, device=device),
                torch.full((B, K), CK.DEAD, dtype=torch.int32, device=device))

    if cfg.n_layers > 1:
        P_carry = cl.Pc_pad if cl is not None else cfg.slayout().P_pad
        layers = [one(P_carry) for _ in range(cfg.n_layers)]
        return {k: tuple(t[i] for t in layers)
                for i, k in enumerate(("a", "vals", "idx"))}
    a, vals, idx = one(cl.Pc_pad if cl is not None else cfg.layout().P_pad)
    return {"a": a, "vals": vals, "idx": idx}


def compact_step(cfg: ScaledRTRLConfig, w, state: dict, x_t: torch.Tensor,
                 cl: SP.ColLayout | None = None, *,
                 backend: str = "compact"):
    """One RTRL step with the row-compact influence: (state', overflow),
    overflow [B] (single layer) or [L] (the max over the batch, a layer).

    backend "compact" runs `sparse_rtrl.flat_compact_step`; "compact_fused"
    (requires `cl`) one K1 launch a layer.  With n_layers > 1, `w` is the
    list of per-layer trees and every layer is carried compact on the
    shared column axis (`stacked_rtrl.stacked_compact_step`)."""
    if backend not in ("compact", "compact_fused"):
        raise ValueError(f"scaled backend must be 'compact' or "
                         f"'compact_fused', got {backend!r}")
    if backend == "compact_fused" and cl is None:
        raise ValueError("compact_fused always carries the parameter axis "
                         "column-compact: pass cl")
    if cfg.n_layers > 1:
        a_new, _, vals, idx, overflow = ST.stacked_compact_step(
            cfg.stacked_cfg(), w, cfg.slayout(), state["a"], state["vals"],
            state["idx"], x_t, cl=cl, backend=backend)
        return {"a": a_new, "vals": vals, "idx": idx}, overflow
    if backend == "compact_fused":
        a_new, _, vals, idx, _, overflow = SP.flat_compact_fused_step(
            cfg.cell_cfg(), w, cfg.layout(), state["a"], state["vals"],
            state["idx"], x_t, cl=cl)
    else:
        a_new, _, vals, idx, _, overflow = SP.flat_compact_step(
            cfg.cell_cfg(), w, cfg.layout(), state["a"], state["vals"],
            state["idx"], x_t, cl=cl)
    return {"a": a_new, "vals": vals, "idx": idx}, overflow


def dense_step(cfg: ScaledRTRLConfig, w, a_prev: torch.Tensor,
               M: torch.Tensor, x_t: torch.Tensor):
    """Masked-dense yardstick: M [B, n, n, m]; FLOPs ~ n * n * n * m."""
    a_new, hp, Jhat, mbar = cell_partials(cfg.cell_cfg(), w, a_prev, x_t)
    T = torch.einsum("bkl,blqm->bkqm", Jhat, M)
    idx = torch.arange(cfg.n, device=M.device)
    add = mbar["v_diag_coef"][:, :, None] * mbar["v_g"][:, None, :]
    T[:, idx, idx, :] += add
    return a_new, hp[:, :, None, None] * T


def compact_to_dense_M(cfg: ScaledRTRLConfig, state: dict,
                       cl: SP.ColLayout | None = None) -> torch.Tensor:
    """The single-layer compact carry scattered back to M [B, n, n, m]."""
    B, n, m = cfg.batch, cfg.n, cfg.m
    vals = state["vals"].float()
    if cl is not None:           # scatter live columns back to the full axis
        vals = SP.cols_to_flat(cl, vals)
    out = vals.new_zeros((B, n + 1, vals.shape[-1]))
    idx = torch.where(state["idx"] < 0, n, state["idx"]).long()
    out[torch.arange(B, device=idx.device)[:, None], idx] = vals
    return out[:, :n, :n * m].reshape(B, n, n, m)


# ---------------------------------------------------------------------------
# Training step (gradient accumulation over a sequence)
# ---------------------------------------------------------------------------

def rtrl_grads(cfg: ScaledRTRLConfig, params: Tree, xs: torch.Tensor,
               labels: torch.Tensor, masks: Tree | None = None, *,
               col_compact: bool | None = None, backend: str = "compact",
               influence_dtype: str = "float32"):
    """xs [T, B, n_in], labels [B].  Exact RTRL with the compact influence
    (exact while nothing overflows).  Returns (loss, grads, stats);
    stats["overflow"] is the per-step row overflow ([T], or [T, L]).

    With `masks` (col_compact None = on) the carry is dual compact.  A
    whole-sequence scan over the streaming learner
    (`core.learner.ScaledLearner`), whose step online training runs."""
    from repro_torch.core.learner import LearnerSpec, make_learner, scan_learner
    learner = make_learner(LearnerSpec(
        engine="scaled", cfg=cfg, col_compact=col_compact, backend=backend,
        influence_dtype=influence_dtype))
    return scan_learner(learner, params, masks, xs, labels)


def sharded_step_specs(cfg: ScaledRTRLConfig, mesh):
    """NamedShardings for the distributed RTRL step: batch -> data, the flat
    parameter-column axis p of the influence state -> model (no
    cross-shard reduction exists in the update).  In a stack every layer's
    buffer shards the SAME way: the (l, j) blocks live along the column
    axis, so layer blocks stay embarrassingly parallel across the model
    axis and the cross-layer term contracts over rows (replicated), adding
    no collectives.  Returns (state shardings, xs [T, B, n_in] sharding);
    `mesh` is a DeviceMesh, or its {name: size} for the specs alone."""
    ba = "data" if "pod" not in mesh_shape(mesh) else ("pod", "data")
    ns = lambda *spec: NamedSharding(mesh, spec)
    if cfg.n_layers > 1:
        L = cfg.n_layers
        state_sh = {"a": tuple(ns(ba, None) for _ in range(L)),
                    "vals": tuple(ns(ba, None, "model") for _ in range(L)),
                    "idx": tuple(ns(ba, None) for _ in range(L))}
    else:
        state_sh = {"a": ns(ba, None), "vals": ns(ba, None, "model"),
                    "idx": ns(ba, None)}
    x_sh = ns(None, ba, None)
    return state_sh, x_sh
