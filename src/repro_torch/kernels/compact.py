"""Capacity-based row compaction of the influence carry, as torch ops.

Counterpart of `repro.kernels.compact`.  The influence matrix is carried in
compact form (values [B, K, P] + active-row indices [B, K], -1 = dead slot)
across timesteps; the update contracts [K x K_prev] x [K_prev x P], so the
work is  K * K_prev * P ~= beta~(t) beta~(t-1) n^2 p.  Every function is
width-agnostic in P, so the same code runs on the column-compact carry
([B, K, Pc_pad]) of the dual (row x column) compaction.

This module has no kernel of its own: backend "compact" is gathers plus a
batched matrix product, as in the JAX package.  The fused form of the same
update is the hand-written kernel in `repro_torch.kernels.compact_fused`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels._build import is_transformed

DEAD = -1   # THE dead-slot sentinel: every idx array here is -1 or in [0, n)


class CompactInfluence(NamedTuple):
    vals: torch.Tensor    # [B, K, P]   compacted rows of M
    idx: torch.Tensor     # [B, K]      row index per slot (-1 = dead slot)
    count: torch.Tensor   # [B]         number of live rows


def check_idx(idx: torch.Tensor, n: int) -> None:
    """Assert the -1 dead-slot convention: every entry is DEAD or a valid
    row in [0, n).  Checked on plain CPU tensors only — on the card the
    check would stall the stream for a device-to-host copy every step, as
    the JAX package skips it under jit, and under `torch.func.vmap` (the
    stream fleet) a tensor cannot steer Python control flow, as a traced
    value cannot under jit."""
    if idx.device.type != "cpu" or is_transformed(idx):
        return
    bad = (idx != DEAD) & ((idx < 0) | (idx >= n))
    if bool(bad.any()):
        raise ValueError(
            f"compact idx violates the -1 sentinel convention: entries "
            f"{torch.unique(idx[bad]).tolist()} outside {{-1}} u [0, {n})")


def compact_rows(dense_rows_mask: torch.Tensor, K: int):
    """dense_rows_mask: [B, n] bool -> (idx [B,K] int32, -1 = dead slot;
    count [B] int32)."""
    B, n = dense_rows_mask.shape
    # stable order: active rows first, by index (keys are unique)
    ar = torch.arange(n, device=dense_rows_mask.device)
    key = (~dense_rows_mask).long() * (n + 1) + ar[None]
    order = torch.argsort(key, dim=1)[:, :K]                    # [B, K]
    if K > n:   # alignment can push capacity past n: pad with dead slots
        order = torch.nn.functional.pad(order, (0, K - n), value=DEAD)
    count = dense_rows_mask.sum(dim=1)
    slot_live = torch.arange(K, device=order.device)[None, :] < count[:, None]
    idx = torch.where(slot_live, order, DEAD)
    return idx.int(), count.int()


def compact_init(B: int, K: int, P: int, dtype: torch.dtype = torch.float32,
                 *, device: torch.device | str) -> CompactInfluence:
    return CompactInfluence(
        torch.zeros((B, K, P), dtype=dtype, device=device),
        torch.full((B, K), DEAD, dtype=torch.int32, device=device),
        torch.zeros((B,), dtype=torch.int32, device=device))


def gather_tiles(A: torch.Tensor | None, idx_row: torch.Tensor,
                 idx_col: torch.Tensor, *, AT: torch.Tensor | None = None):
    """Gathered [B, K, K_col] tiles of a (possibly rectangular) Jacobian:
    rows at `idx_row`, columns at `idx_col` (dead column slots contribute
    zero columns; dead rows are gated by hp downstream).  Pass the dense
    per-example ``A`` [B, n_row, n_col] (data-dependent Jacobians: the
    EGRU J-hat, the cross-layer B-hat), or ``AT`` [n_col, n_row] — a weight
    matrix whose TRANSPOSE is the Jacobian (R for the vanilla RNN's J-hat,
    W for its B-hat) — so tiles are looked up directly."""
    if AT is not None:
        n_col, n_row = AT.shape
    else:
        n_row, n_col = A.shape[-2], A.shape[-1]
    check_idx(idx_row, n_row)
    check_idx(idx_col, n_col)
    B, K = idx_row.shape
    Kc = idx_col.shape[1]
    safe_row = idx_row.clamp(0, n_row - 1).long()
    safe_col = idx_col.clamp(0, n_col - 1).long()
    live_col = idx_col >= 0
    if AT is not None:
        # A[b, k, j] = AT[j, k]
        Agg = AT[safe_col[:, None, :], safe_row[:, :, None]]    # [B, K, Kc]
    else:
        bidx = torch.arange(B, device=A.device)[:, None]
        Ag = A[bidx, safe_row]                                  # [B, K, n_col]
        Agg = Ag.gather(2, safe_col[:, None, :].expand(B, K, Kc))
    return Agg * live_col[:, None, :]


def gather_j_tiles(Jhat: torch.Tensor | None, idx_new: torch.Tensor,
                   idx_prev: torch.Tensor, *, R: torch.Tensor | None = None):
    """Gathered [B, K, K_prev] tiles of the (square) step Jacobian J-hat:
    rows at the newly-active unit indices, columns at the previously-active
    ones."""
    return gather_tiles(Jhat, idx_new, idx_prev, AT=R)


def compact_update(Jgg: torch.Tensor, vals_prev: torch.Tensor,
                   mbar_rows: torch.Tensor, hp_rows: torch.Tensor,
                   idx_new: torch.Tensor, count: torch.Tensor, K: int):
    """The shared compact contraction:  vals = hp ⊙ (Jgg @ vals_prev + M-bar).

    Accumulates in f32 whatever the carry dtype (a bf16 carry is read as
    f32 and cast back once, on write).  Returns (CompactInfluence,
    overflow [B])."""
    T = torch.bmm(Jgg, vals_prev.float())
    vals = (hp_rows[:, :, None] * (T + mbar_rows.float())).to(vals_prev.dtype)
    overflow = (count - K).clamp(min=0)
    return CompactInfluence(vals, idx_new, count.clamp(max=K)), overflow


def compact_influence_step(hp: torch.Tensor, Jhat: torch.Tensor,
                           Mc: CompactInfluence, Mbar: torch.Tensor, K: int):
    """One RTRL influence update in compact form (the row-compact-only
    path).  hp [B,n]; Jhat [B,n,n]; Mbar [B,n,P]; returns (Mc', overflow
    [B]).  The work scales as K * K * P instead of n * n * P."""
    B, n, P = Mbar.shape
    idx_new, count_new = compact_rows(hp != 0.0, K)             # rows of M_t
    bidx = torch.arange(B, device=hp.device)[:, None]
    safe_new = idx_new.clamp(0, n - 1).long()
    live = idx_new >= 0
    Jgg = gather_j_tiles(Jhat, idx_new, Mc.idx)
    Mbar_g = Mbar[bidx, safe_new]                               # [B, K, P]
    hp_g = hp[bidx, safe_new] * live                            # [B, K]
    return compact_update(Jgg, Mc.vals, Mbar_g, hp_g, idx_new, count_new, K)


def row_contract(c: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """sum_b sum_k c[b, k] M[b, k, :] in f32: per example over the rows,
    then over the batch — the JAX package's order — as products and two
    sums over leading axes, so that a slot of the stream fleet (vmapped)
    rounds as the same call alone (a batched library product would not:
    cuBLAS picks its kernel by the batch count)."""
    return (c[:, :, None] * M.float()).sum(dim=1).sum(dim=0)


def compact_grads(vals: torch.Tensor, idx: torch.Tensor, cbar: torch.Tensor):
    """Fused gradient extraction  dL/dw = c-bar^T M  on the compact form.

    c-bar [B, n] is gathered at the active rows and contracted with vals
    [B, K, P] per example, then summed over the batch (`row_contract`).
    Returns the flat gradient [P] in f32."""
    n = cbar.shape[1]
    check_idx(idx, n)
    safe = idx.clamp(0, n - 1).long()
    live = idx >= 0
    cb = cbar.gather(1, safe) * live                            # [B, K]
    return row_contract(cb, vals)


def compact_to_dense(Mc: CompactInfluence, n: int) -> torch.Tensor:
    """Scatter back to [B, n, P] (for verification).  Dead slots land in a
    scratch row that is cropped; live rows are unique per example, so this
    is a plain index assignment."""
    check_idx(Mc.idx, n)
    B, K, P = Mc.vals.shape
    out = Mc.vals.new_zeros((B, n + 1, P))
    idx = torch.where(Mc.idx < 0, n, Mc.idx).long()
    out[torch.arange(B, device=idx.device)[:, None], idx] = Mc.vals
    return out[:, :n]
