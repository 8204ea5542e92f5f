"""Exact influence-carry migration between two ColLayouts, in PyTorch.

Counterpart of `repro.sparsity.migrate`.  A rewire event replaces the
masks, so the live-column set of the compact influence carry changes.
Migration is exact:

  * surviving columns (live under both masks) keep their influence bit for
    bit — a pure gather times 1.0;
  * grown columns come back exactly 0 (the grown weight starts at 0, and
    a restarted engine carries zero influence for it);
  * pruned columns are dropped, and so are their entries of the gradient
    accumulator (events fire at update boundaries, where it was just
    consumed).

`migrate_influence` equals the scatter oracle `migrate_via_flat` bit for
bit, as one gather on the compact axis (O(B K Pc), never the full
[..., P_pad] buffer).  Count-preserving rewire keeps Pc_pad, so one plan
shape serves every event, and one plan remaps every layer's buffer of a
stacked carry (they share the stacked ColLayout).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import sparse_rtrl as SP

Tree = Any


def migration_plan(old_cl: "SP.ColLayout", new_cl: "SP.ColLayout"):
    """The surviving-column gather between two ColLayouts.

    Returns (gather [Pc_pad] int64, carried [Pc_pad] float32) on new_cl's
    device: new compact column c reads old compact column gather[c] iff
    carried[c] == 1 (its flat source column is live under both masks);
    grown and pad columns read 0.  Host numpy, one searchsorted (the src
    maps are strictly increasing over their Pc live entries)."""
    if (old_cl.Pc_pad, old_cl.P_pad) != (new_cl.Pc_pad, new_cl.P_pad):
        raise ValueError(
            "migration requires equal compact widths (count-preserving "
            f"rewire): old Pc_pad={old_cl.Pc_pad}/P_pad={old_cl.P_pad}, "
            f"new Pc_pad={new_cl.Pc_pad}/P_pad={new_cl.P_pad}")
    old_src = SP._np(old_cl.src)[:old_cl.Pc]
    new_src = SP._np(new_cl.src)
    live_new = SP._np(new_cl.live) > 0
    pos = np.searchsorted(old_src, new_src)
    safe = np.minimum(pos, max(old_src.size - 1, 0))
    carried = live_new & (pos < old_src.size) & (old_src[safe] == new_src)
    gather = np.where(carried, safe, 0).astype(np.int64)
    device = new_cl.src.device
    return (torch.from_numpy(gather).to(device),
            torch.from_numpy(carried.astype(np.float32)).to(device))


def migrate_influence(old_cl: "SP.ColLayout", new_cl: "SP.ColLayout",
                      M: torch.Tensor, plan=None) -> torch.Tensor:
    """Remap a compact-column buffer [..., Pc_pad] from old_cl to new_cl.

    Surviving columns carry bit for bit, grown and pad columns come back
    exactly zero, in M's dtype.  Works on the row-compact vals [B, K,
    Pc_pad], the full-row pallas buffer [B, n, Pc_pad] and the gradient
    accumulator [Pc_pad] (whose pruned entries this flushes)."""
    gather, carried = migration_plan(old_cl, new_cl) if plan is None else plan
    return (M.index_select(-1, gather) * carried).to(M.dtype)


def migrate_flat(new_col_mask: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Full-width sibling: on a [..., P_pad] carry the column set is the
    flat axis itself, so migration kills the newly dead columns (grown
    columns are already exactly zero: the old column mask kept them so)."""
    return (M * new_col_mask).to(M.dtype)


def gate_col_mask(cfg, masks: Tree, g: str) -> torch.Tensor:
    """Per-gate (q, m) column liveness of the masked-dense influence dict —
    the concatenation `influence_update` gates its M-bar with."""
    n = cfg.n_hidden
    mk = masks[g]
    ones = torch.ones((n, 1), device=mk["R"].device)
    cols = [mk["W"].T, mk["R"].T, ones]
    if cfg.kind == "rnn":
        cols.append(ones)                       # folded theta column
    return torch.cat(cols, dim=1)


def migrate_dense(cfg, M: Tree, new_masks: Tree) -> Tree:
    """Masked-dense per-gate influence dict migration: newly dead (q, m)
    columns are zeroed; grown ones are already exactly zero (the dense
    update masks M-bar every step, and J M cannot repopulate a zero
    column).  theta is never masked."""
    return {g: Mg if g == "theta"
            else Mg * gate_col_mask(cfg, new_masks, g)[None, None]
            for g, Mg in M.items()}


def migrate_via_flat(old_cl: "SP.ColLayout", new_cl: "SP.ColLayout",
                     M: torch.Tensor) -> torch.Tensor:
    """The scatter ORACLE: scatter the compact buffer to the full [...,
    P_pad] axis and re-gather under the new layout.  Used only by tests to
    hold `migrate_influence` bit for bit."""
    return SP.flat_to_cols(new_cl, SP.cols_to_flat(old_cl, M))


# ---------------------------------------------------------------------------
# The restart oracle (tests and the chip smoke run hold rewire against it)
# ---------------------------------------------------------------------------

def _scatter_rows(vals: torch.Tensor, idx: torch.Tensor, n: int):
    """Row-compact [B, K, P] + idx [B, K] (-1 = dead) -> full [B, n, P]."""
    B = vals.shape[0]
    out = vals.new_zeros((B, n + 1) + tuple(vals.shape[2:]))
    safe = torch.where(idx < 0, n, idx).long()
    out[torch.arange(B, device=vals.device)[:, None], safe] = vals
    return out[:, :n]


def flat_influence(learner, carry: Tree) -> tuple:
    """A flat-carry learner's influence on the full flat axis: one [B, n,
    P_pad] f32 tensor a layer (the compact axis scattered back through the
    carry's ColLayout, the rows through its indices)."""
    inner = getattr(learner, "inner", learner)    # the L = 1 delegation
    inner._sync(carry)
    cl = inner._cl
    sizes = getattr(inner.cfg, "layer_sizes", None) or (inner.cfg.n_hidden,)
    if "M" in carry:
        Ms = carry["M"] if isinstance(carry["M"], tuple) else (carry["M"],)
        return tuple(M if cl is None else SP.cols_to_flat(cl, M) for M in Ms)
    tup = isinstance(carry["vals"], tuple)
    vals = carry["vals"] if tup else (carry["vals"],)
    idx = carry["idx"] if tup else (carry["idx"],)
    out = []
    for v, i, n in zip(vals, idx, sizes):
        v = v.float()
        out.append(_scatter_rows(v if cl is None else SP.cols_to_flat(cl, v),
                                 i, n))
    return tuple(out)


def _flat_to_gates(layout: "SP.FlatLayout", flat: torch.Tensor) -> dict:
    """[B, n, P_pad] flat influence -> the masked-dense per-gate dict."""
    n, m, B = layout.n, layout.m, flat.shape[0]
    out = {g: flat[..., i * n * m:(i + 1) * n * m].reshape(B, n, n, m)
           for i, g in enumerate(layout.gates)}
    if layout.kind != "rnn":
        out["theta"] = flat[..., layout.theta_offset:layout.theta_offset + n]
    return out


def _gates_to_flat(layout: "SP.FlatLayout", M: dict, P_pad: int):
    """The masked-dense per-gate dict -> [B, n, P_pad] flat influence."""
    B, n = M[layout.gates[0]].shape[:2]
    blocks = [M[g].reshape(B, n, -1) for g in layout.gates]
    if layout.kind != "rnn":
        blocks.append(M["theta"])
    flat = torch.cat(blocks, dim=-1)
    return torch.nn.functional.pad(flat, (0, P_pad - flat.shape[-1]))


def restart_oracle(learner, carry: Tree):
    """The restart oracle of a rewirable carry: (oracle, oracle_carry), a
    FRESH masked-dense learner built on the carry's current masks and fed
    its params, activity and influence (scattered back to the flat axis).
    Grown weights start at 0 with zero influence, so after an event at an
    update boundary, stepping both on the same inputs gives the same
    gradients (to f32 round-off: the dense update sums in another order).
    A single-layer learner gets the single-layer dense engine, a stacked
    one (the L = 1 delegation included) the stacked dense engine."""
    from repro_torch.core.learner import (LearnerSpec, SparseLearner,
                                          make_learner)
    from repro_torch.core import stacked_rtrl as ST
    last, tt = carry["last"], float(carry["t_total"])
    if isinstance(learner, SparseLearner):
        oracle = make_learner(LearnerSpec(engine="sparse", cfg=learner.cfg,
                                          backend="dense"))
        oc = oracle.init(carry["params"], carry["rw"]["masks"],
                         (last["x"], last["y"]), t_total=tt)
        oc["M"] = carry["M"] if learner.backend == "dense" else \
            _flat_to_gates(SP.flat_layout(learner.cfg),
                           flat_influence(learner, carry)[0])
        oc["a"], oc["beta_prev"] = carry["a"], carry["beta_prev"]
        return oracle, oc
    cfg = learner.cfg
    oracle = make_learner(LearnerSpec(engine="stacked", cfg=cfg,
                                      backend="dense",
                                      delegate_single_layer=False))
    oc = oracle.init(learner.params_of(carry),
                     learner.opt_mask_of(carry)["layers"],
                     (last["x"], last["y"]), t_total=tt)
    P_pad = ST.stacked_layout(cfg).P_pad
    inner = getattr(learner, "inner", None)
    if inner is None:
        oc["M"] = flat_influence(learner, carry)
        oc["a"], oc["beta_prev"] = carry["a"], carry["beta_prev"]
        return oracle, oc
    flat = _gates_to_flat(SP.flat_layout(inner.cfg), carry["M"], P_pad) \
        if inner.backend == "dense" else flat_influence(learner, carry)[0]
    oc["M"] = (torch.nn.functional.pad(flat, (0, P_pad - flat.shape[-1])),)
    oc["a"], oc["beta_prev"] = (carry["a"],), carry["beta_prev"].reshape(1)
    return oracle, oc


def migrate_sharded(plan, bufs: list, mesh, c0: int) -> list:
    """`migrate_influence` of column-sharded buffers: each of `bufs` is
    this rank's [..., w] slice (columns [c0, c0 + w)) of a [..., Pc_pad]
    buffer split over the mesh's 'model' dim.  The slices are gathered in
    ONE all_gather over 'model' (their rows concatenated, read as f32, an
    exact widening of a bf16 carry), and each rank keeps its new columns:
    the plan's gather and carried entries at [c0, c0 + w).  Bitwise the
    unsharded migration's columns."""
    from repro_torch import sharding as SH
    gather, carried = plan
    w = bufs[0].shape[-1]
    rows = [b.reshape(-1, w).float() for b in bufs]
    full = SH.all_gather(torch.cat(rows), mesh, "model", axis=1)
    sl = slice(c0, c0 + w)
    new = full.index_select(-1, gather[sl]) * carried[sl]
    out, r = [], 0
    for b, part in zip(bufs, rows):
        out.append(new[r:r + part.shape[0]].reshape(b.shape).to(b.dtype))
        r += part.shape[0]
    return out
