"""EXACT RTRL with combined activity + parameter sparsity, in PyTorch.

Counterpart of `repro.core.sparse_rtrl`.  Two representations of the
influence matrix coexist, as there:

  * the per-gate dict ({u,r,z,theta} / {v}: [B, n, n, m]) of the
    masked-dense reference backend "dense" (`influence_update`);
  * the FLAT layout (`FlatLayout`: every gate's (q, m) column groups along
    one lane-padded parameter axis), carried dense ([B, n, P], backend
    "pallas") or row-compact ([B, K, .] + active-row indices, backends
    "compact" and "compact_fused") and — with fixed parameter masks, whose
    live column set is static — column-compact (`ColLayout`, width
    Pc ~= w~ P).

  influence_update         backend "dense": masked-dense per-gate einsums
  pallas_step_operands     backend "pallas": the operands of the
                           block-sparse update `kernels.ops.influence_update`
                           (the hand-written CUDA kernel of
                           `kernels.influence`, its plain version on CPU)
  flat_compact_step        backend "compact": gathers + batched product
  flat_compact_fused_step  backend "compact_fused": the hand-written CUDA
                           kernel `kernels.compact_fused.fused_update`
                           (its plain PyTorch version on CPU tensors)

The compact step costs K * K_prev * Pc ~= w~ beta~(t) beta~(t-1) n^2 p: the
paper's combined activity x parameter factor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.cells.egru import cell_partials, cell_partials_full
from repro_torch.core.cells import EGRUConfig
from repro_torch.kernels import compact as CK, compact_fused as CF
from repro_torch.tree import apply_mask_tree

Tree = Any

LANE = 128        # flat influence buffers are padded to a multiple of this


# ---------------------------------------------------------------------------
# Parameter-sparsity masks (fixed at init — paper Sec. 6)
# ---------------------------------------------------------------------------

def mask_gates(kind: str) -> tuple:
    """The gates whose W/R matrices are maskable, in canonical order."""
    return ("v",) if kind == "rnn" else ("u", "r", "z")


def make_masks(cfg: EGRUConfig, gen: torch.Generator, sparsity: float, *,
               device: torch.device | str, block: int = 1,
               mask_input: bool = True) -> Tree:
    """Random fixed masks with density (1 - sparsity).

    Draws uniforms from `gen` (on the CPU) in gate order, W then R per gate.
    block > 1 draws at [block x block] granularity; block=1 is the paper's
    unstructured setting."""
    def bernoulli(shape):
        if block == 1:
            u = torch.rand(shape, generator=gen)
            return (u >= sparsity).float()
        bshape = tuple(-(-s // block) for s in shape)
        coarse = (torch.rand(bshape, generator=gen) >= sparsity).float()
        rows = torch.arange(shape[0]) // block
        cols = torch.arange(shape[1]) // block
        return coarse[rows][:, cols]

    masks = {}
    for g in mask_gates(cfg.kind):
        W = bernoulli((cfg.n_in, cfg.n_hidden)) if mask_input \
            else torch.ones((cfg.n_in, cfg.n_hidden))
        R = bernoulli((cfg.n_hidden, cfg.n_hidden))
        masks[g] = {"W": W.to(device), "R": R.to(device),
                    "b": torch.ones((cfg.n_hidden,), device=device)}
    masks["theta"] = torch.ones((cfg.n_hidden,), device=device)
    masks["out"] = None          # readout stays dense
    return masks


def apply_masks(params: Tree, masks: Tree) -> Tree:
    """params * masks leaf-wise (None mask = leave the subtree dense)."""
    return apply_mask_tree(masks, params)


def mask_counts(masks: Tree) -> tuple:
    """(nonzero, total) entries over the maskable recurrent params (W/R;
    not bias, theta, or the readout)."""
    tot, nz = 0.0, 0.0
    for g, sub in masks.items():
        if g in ("out", "theta") or sub is None:
            continue
        for k in ("W", "R"):
            tot += sub[k].numel()
            nz += float(sub[k].sum())
    return nz, tot


def omega_tilde(masks: Tree) -> float:
    """Measured parameter density (over maskable recurrent params)."""
    nz, tot = mask_counts(masks)
    return nz / tot


# ---------------------------------------------------------------------------
# Per-gate influence state: the masked-dense reference backend "dense"
# ---------------------------------------------------------------------------

def init_influence(cfg: EGRUConfig, batch: int, *,
                   device: torch.device | str) -> Tree:
    n, m1 = cfg.n_hidden, cfg.n_in + cfg.n_hidden + 1
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.kind == "rnn":
        return {"v": torch.zeros((batch, n, n, m1 + 1), **f32)}
    M = {g: torch.zeros((batch, n, n, m1), **f32) for g in ("u", "r", "z")}
    M["theta"] = torch.zeros((batch, n, n), **f32)
    return M


def influence_update(cfg: EGRUConfig, M: Tree, hp: torch.Tensor,
                     Jhat: torch.Tensor, mbar: Tree,
                     masks: Tree | None = None) -> Tree:
    """M_t = D(hp) [ J-hat M_{t-1} + Mbar-hat ]   — Eq. (10) exactly.

    The diagonal (k == q) adds are index assignments on the unique unit
    indices, so they are deterministic on CUDA (no scatter-add)."""
    n = cfg.n_hidden
    idx = torch.arange(n, device=hp.device)

    def jm(Mg):   # [B,n,n,m] or [B,n,n]
        if Mg.ndim == 4:
            return torch.einsum("bkl,blqm->bkqm", Jhat, Mg)
        return torch.einsum("bkl,blq->bkq", Jhat, Mg)

    def gmask(g):
        if masks is None or g not in masks:
            return None
        mk = masks[g]
        return torch.cat([mk["W"].T, mk["R"].T, mk["W"].new_ones((n, 1))],
                         dim=1)                                 # [n(q), m]

    def add_diag(T, add):
        T[:, idx, idx] = T[:, idx, idx] + add
        return T

    new = {}
    if cfg.kind == "rnn":
        add = mbar["v_diag_coef"][:, :, None] * mbar["v_g"][:, None, :]
        mk = gmask("v")
        if mk is not None:
            mk = torch.cat([mk, mk.new_ones((n, 1))], dim=1)    # theta col
            add = add * mk[None]
        new["v"] = hp[:, :, None, None] * add_diag(jm(M["v"]), add)
        return new

    for g in ("u", "z"):
        add = mbar[f"{g}_diag_coef"][:, :, None] * mbar[f"{g}_g"][:, None, :]
        mk = gmask(g)
        if mk is not None:
            add = add * mk[None]
        new[g] = hp[:, :, None, None] * add_diag(jm(M[g]), add)
    # r gate: dense (k, q) coupling through R_z
    add = mbar["r_coef"][:, :, :, None] * mbar["r_g"][:, None, None, :]
    mk = gmask("r")
    if mk is not None:
        add = add * mk[None, None]
    new["r"] = hp[:, :, None, None] * (jm(M["r"]) + add)
    # theta: dv_k/dtheta_q = -delta_kq
    new["theta"] = hp[:, :, None] * add_diag(jm(M["theta"]), -1.0)
    return new


def influence_grads(cfg: EGRUConfig, M: Tree, cbar: torch.Tensor) -> Tree:
    """dL_t/dw += cbar_t^T M_t, mapped back to parameter structure."""
    n, n_in = cfg.n_hidden, cfg.n_in

    def split_g(gw):   # [q, m] -> dict(W [n_in,n], R [n,n], b [n])
        return {"W": gw[:, :n_in].T, "R": gw[:, n_in:n_in + n].T,
                "b": gw[:, n_in + n]}

    if cfg.kind == "rnn":
        gw = torch.einsum("bk,bkqm->qm", cbar, M["v"])
        return {"v": split_g(gw), "theta": gw[:, -1]}
    out = {g: split_g(torch.einsum("bk,bkqm->qm", cbar, M[g]))
           for g in ("u", "r", "z")}
    out["theta"] = torch.einsum("bk,bkq->q", cbar, M["theta"])
    return out


def _row_density(M: Tree) -> torch.Tensor:
    """Fraction of nonzero rows of the influence matrix (memory measure)."""
    dens = [(Mg.reshape(Mg.shape[0], Mg.shape[1], -1) != 0.0).any(dim=2)
            .float().mean() for Mg in M.values()]
    return torch.stack(dens).mean()


def influence_col_density(M: Tree) -> torch.Tensor:
    """Fraction of nonzero (q, m) columns — parameter-sparsity invariant."""
    dens = [(Mg.reshape(Mg.shape[0] * Mg.shape[1], -1) != 0.0).any(dim=0)
            .float().mean() for Mg in M.values()]
    return torch.stack(dens).mean()


# ---------------------------------------------------------------------------
# Flat influence layout: all gates in one [B, n, P] buffer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static column layout of the flat influence buffer.

    Column  gate_offset(g) + q * m + j  holds  d a_k / d (j-th param of unit
    q's gate-g group), groups ordered (W col, R col, bias[, theta]).  For
    'rnn' theta is folded into the per-unit group (j == m-1); for 'gru' theta
    gets its own trailing n-column block.  P == p; P_pad rounds up to LANE."""
    kind: str
    n: int
    n_in: int
    gates: tuple
    m: int                 # per-gate per-unit parameter-group width
    P: int                 # logical column count (== cfg.n_rec_params)
    P_pad: int             # P rounded up to a LANE multiple
    influence_dtype: str = "float32"   # carry dtype ("float32" | "bfloat16")

    @property
    def theta_offset(self) -> int:          # gru only: trailing theta block
        return len(self.gates) * self.n * self.m

    @property
    def carry_dtype(self) -> torch.dtype:
        return influence_carry_dtype(self.influence_dtype)


INFLUENCE_DTYPES = ("float32", "bfloat16")


def influence_carry_dtype(name: str) -> torch.dtype:
    """Resolve the influence-carry dtype string.  A bf16 carry halves the
    per-stream bytes; every contraction still accumulates in f32."""
    if name in ("float32", "f32"):
        return torch.float32
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"influence_dtype {name!r} not in {INFLUENCE_DTYPES}")


def flat_layout(cfg: EGRUConfig,
                influence_dtype: str = "float32") -> FlatLayout:
    n, n_in = cfg.n_hidden, cfg.n_in
    if cfg.kind == "rnn":
        gates, m = ("v",), n_in + n + 2              # W, R, b, theta
        P = n * m
    else:
        gates, m = ("u", "r", "z"), n_in + n + 1     # W, R, b
        P = 3 * n * m + n                            # + theta block
    if P != cfg.n_rec_params:
        raise ValueError(f"flat layout width {P} != {cfg.n_rec_params}")
    P_pad = -(-P // LANE) * LANE
    return FlatLayout(cfg.kind, n, n_in, gates, m, P, P_pad, influence_dtype)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _flat_col_mask_np(layout: FlatLayout, masks: Tree | None) -> np.ndarray:
    """Host (numpy) [P] column liveness from the fixed parameter masks."""
    if masks is None:
        return np.ones((layout.P,), np.float32)
    n = layout.n
    parts = []
    for g in layout.gates:
        mk = masks[g]
        cols = [_np(mk["W"]).T, _np(mk["R"]).T, np.ones((n, 1), np.float32)]
        if layout.kind == "rnn":
            cols.append(np.ones((n, 1), np.float32))     # theta column
        parts.append(np.concatenate(cols, axis=1).reshape(-1))
    if layout.kind != "rnn":
        parts.append(np.ones((n,), np.float32))          # theta block
    return np.concatenate(parts).astype(np.float32)


def flat_col_mask(layout: FlatLayout, masks: Tree | None, *,
                  device: torch.device | str) -> torch.Tensor:
    """[P_pad] column liveness from the fixed parameter masks (Sec. 5);
    padding columns are dead."""
    live = np.pad(_flat_col_mask_np(layout, masks), (0, layout.P_pad - layout.P))
    return torch.from_numpy(live).to(device)


def init_influence_flat(layout: FlatLayout, batch: int, *,
                        device: torch.device | str) -> torch.Tensor:
    return torch.zeros((batch, layout.n, layout.P_pad),
                       dtype=layout.carry_dtype, device=device)


def flat_jmask(cfg: EGRUConfig, masks: Tree | None) -> torch.Tensor | None:
    """Static [n, n] sparsity pattern of J-hat in R layout ([l, k]), or None.

    J inherits the masks' pattern (Sec. 5): for 'rnn' J-hat = R^T exactly;
    for 'gru' the three R paths union with the diagonal (1-u) term and the
    two-hop r-path  R_r @ R_z.  Note the layout: J-hat[k, l] lives at
    [l, k] here, as in R."""
    if masks is None:
        return None
    if cfg.kind == "rnn":
        return (masks["v"]["R"] > 0).float()
    mu, mr, mz = (masks[g]["R"] for g in ("u", "r", "z"))
    pat = mu + mz + mr @ mz + torch.eye(cfg.n_hidden, device=mu.device)
    return (pat > 0).float()


# ---------------------------------------------------------------------------
# Column compaction: the fixed masks make the live (q, m)-column set STATIC
# ---------------------------------------------------------------------------

COL_GATE_THETA = 3        # 'gru' trailing theta block ('rnn' folds theta in m)


@dataclasses.dataclass(frozen=True)
class ColLayout:
    """Static live-column map of a (possibly stacked) flat parameter axis.

    Compact column c < Pc holds flat column src[c] of the full P_pad-wide
    axis; (layer, gate, q, j) decompose it into the owning layer, the gate
    block (gates order, COL_GATE_THETA = gru theta block), the unit index q
    and the within-group parameter index j.  Pc_pad rounds up to a LANE
    multiple (pad columns dead, live = 0).  The arrays are int32 / float32
    tensors on the device the layout was built for."""
    Pc: int                # live column count  (~= w~ P)
    Pc_pad: int            # Pc rounded up to a LANE multiple
    P_pad: int             # width of the full flat axis this compacts
    src: torch.Tensor      # [Pc_pad] int32 original flat column (pad: P_pad)
    layer: torch.Tensor    # [Pc_pad] int32 owning layer (pad: -1)
    gate: torch.Tensor     # [Pc_pad] int32 gate id within layer (pad: -1)
    q: torch.Tensor        # [Pc_pad] int32 unit index within layer
    j: torch.Tensor        # [Pc_pad] int32 within-group param index
    live: torch.Tensor     # [Pc_pad] float32 1/0 (pad columns 0)
    influence_dtype: str = "float32"   # carry dtype of [B, K, Pc_pad] vals

    @property
    def carry_dtype(self) -> torch.dtype:
        return influence_carry_dtype(self.influence_dtype)


def _decompose_columns(layout: FlatLayout):
    """(gate, q, j) int arrays [P] for one layer's local flat columns."""
    n, m = layout.n, layout.m
    c = np.arange(layout.P)
    if layout.kind == "rnn":
        return np.zeros_like(c), (c // m), (c % m)
    gate = np.minimum(c // (n * m), COL_GATE_THETA)
    rem = c % (n * m)
    q = np.where(gate < COL_GATE_THETA, rem // m, c - len(layout.gates) * n * m)
    j = np.where(gate < COL_GATE_THETA, rem % m, 0)
    return gate, q, j


def build_col_layout(parts, P_pad: int, influence_dtype: str = "float32", *,
                     device: torch.device | str) -> ColLayout:
    """ColLayout over concatenated per-layer column blocks.

    parts: [(FlatLayout, masks-or-None, column offset, layer id)]."""
    srcs, layers, gates, qs, js = [], [], [], [], []
    for lay, mk, off, lid in parts:
        live = _flat_col_mask_np(lay, mk) > 0
        g, q, j = _decompose_columns(lay)
        idx = np.nonzero(live)[0]
        srcs.append(idx + off)
        layers.append(np.full(idx.size, lid))
        gates.append(g[idx])
        qs.append(q[idx])
        js.append(j[idx])
    src = np.concatenate(srcs)
    Pc = int(src.size)
    Pc_pad = max(LANE, -(-Pc // LANE) * LANE)
    pad = Pc_pad - Pc

    def col(a, fill):
        return torch.from_numpy(np.concatenate(
            [a, np.full(pad, fill)]).astype(np.int32)).to(device)

    live = (np.arange(Pc_pad) < Pc).astype(np.float32)
    return ColLayout(
        Pc=Pc, Pc_pad=Pc_pad, P_pad=P_pad,
        src=col(src, P_pad), layer=col(np.concatenate(layers), -1),
        gate=col(np.concatenate(gates), -1), q=col(np.concatenate(qs), 0),
        j=col(np.concatenate(js), 0),
        live=torch.from_numpy(live).to(device),
        influence_dtype=influence_dtype)


def col_layout(layout: FlatLayout, masks: Tree | None,
               influence_dtype: str | None = None, *,
               device: torch.device | str) -> ColLayout:
    """Single-layer live-column map (masks=None -> all P columns live)."""
    return build_col_layout(
        [(layout, masks, 0, 0)], layout.P_pad,
        layout.influence_dtype if influence_dtype is None else influence_dtype,
        device=device)


def flat_col_density(layout: FlatLayout, masks: Tree | None) -> float:
    """Live fraction of the P logical parameter columns — the omega~ factor
    the column compaction realises (Pc == flat_col_density * P).  Shares
    the one live-fraction definition with `core.costs.carry_footprint`."""
    from repro_torch.core.costs import live_col_fraction
    live = int(_flat_col_mask_np(layout, masks).sum())
    return live_col_fraction(live, layout.P)


def flat_to_cols(cl: ColLayout, x: torch.Tensor) -> torch.Tensor:
    """Gather the live columns: [..., P_pad] -> [..., Pc_pad] (pad cols 0)."""
    safe = cl.src.clamp(0, cl.P_pad - 1).long()
    return x.index_select(-1, safe) * cl.live


def cols_to_flat(cl: ColLayout, x: torch.Tensor) -> torch.Tensor:
    """Scatter back to the full axis: [..., Pc_pad] -> [..., P_pad].

    Live sources are unique, so this is a plain index assignment (not
    `index_add_`, which is nondeterministic on CUDA); pad columns all land
    in a sentinel column (their values are 0) that is cropped.  Dead
    columns of the full axis come back exactly zero."""
    src = torch.where(cl.live > 0, cl.src, cl.P_pad).long()
    out = x.new_zeros(x.shape[:-1] + (cl.P_pad + 1,))
    out[..., src] = x * cl.live
    return out[..., :cl.P_pad]


def flat_mbar_rows_cols(cfg: EGRUConfig, layout: FlatLayout, cl: ColLayout,
                        mbar: Tree, safe_new: torch.Tensor, *,
                        layer: int = 0) -> torch.Tensor:
    """M-bar rows at the active row indices, DIRECTLY at compact column
    width: [B, K, Pc_pad] (hp-ungated).  Diagonal gates (u/z, rnn v) and
    theta only hit columns whose unit q equals the row's unit; the r gate
    couples all live q through R_z, read off mbar['r_coef'].  `layer`
    selects this layer's columns of a stacked axis (others -> 0)."""
    n, m = layout.n, layout.m
    B, K = safe_new.shape
    sel = (cl.layer == layer) & (cl.live > 0)           # [Pc_pad]
    q = torch.where(sel, cl.q, 0).clamp(0, n - 1).long()
    j = torch.where(sel, cl.j, 0).clamp(0, m - 1).long()
    gate = torch.where(sel, cl.gate, -1)
    match = q[None, None, :] == safe_new.long()[:, :, None]   # [B, K, Pc_pad]
    if cfg.kind == "rnn":
        Cdiag = (mbar["v_diag_coef"][:, q] * mbar["v_g"][:, j]
                 * sel.float())                         # [B, Pc_pad]
        return match * Cdiag[:, None, :]
    gu, gr, gz = (layout.gates.index(g) for g in ("u", "r", "z"))
    theta = torch.where(gate == COL_GATE_THETA, -1.0, 0.0)
    Cdiag = torch.where(
        gate == gu, mbar["u_diag_coef"][:, q] * mbar["u_g"][:, j],
        torch.where(gate == gz, mbar["z_diag_coef"][:, q] * mbar["z_g"][:, j],
                    theta))
    out = match * Cdiag[:, None, :]
    # r gate: value[b, k, c] = r_coef[b, row_k, q(c)] * r_g[b, j(c)]
    bidx = torch.arange(B, device=safe_new.device)[:, None]
    rc_rows = mbar["r_coef"][bidx, safe_new.long()]     # [B, K, n]
    rc = rc_rows.gather(2, q[None, None, :].expand(B, K, cl.Pc_pad))
    return out + rc * (mbar["r_g"][:, j] * (gate == gr))[:, None, :]


def flat_mbar_cols(cfg: EGRUConfig, layout: FlatLayout, cl: ColLayout,
                   mbar: Tree, *, layer: int = 0) -> torch.Tensor:
    """Full-row immediate influence at compact column width [B, n, Pc_pad]
    (hp-ungated): the column-compact M-bar of backend "pallas"."""
    B = (mbar["v_g"] if cfg.kind == "rnn" else mbar["u_g"]).shape[0]
    rows = torch.arange(layout.n, device=cl.src.device)[None].expand(
        B, layout.n)
    return flat_mbar_rows_cols(cfg, layout, cl, mbar, rows, layer=layer)


def _place(layout: FlatLayout, flat: torch.Tensor, col_mask, offset: int,
           total_pad: int | None) -> torch.Tensor:
    """Pad a layer's [..., P] M-bar into columns [offset, offset + P) of a
    [..., total_pad] axis (default: the layer's own P_pad), dead columns
    zeroed by `col_mask` [total_pad]."""
    total = layout.P_pad if total_pad is None else total_pad
    flat = torch.nn.functional.pad(flat, (offset, total - offset - layout.P))
    if col_mask is not None:
        flat = flat * col_mask
    return flat


def flat_mbar(cfg: EGRUConfig, layout: FlatLayout, mbar: Tree,
              col_mask: torch.Tensor | None = None, *, offset: int = 0,
              total_pad: int | None = None) -> torch.Tensor:
    """Immediate influence M-bar-hat in flat layout [B, n, total_pad]
    (hp-ungated): the full-width M-bar of backend "pallas".

    u/z (and rnn v) gates are diagonal in (k, q); the r gate couples densely
    through R_z; theta is -I.  `offset` places the layer's P columns inside
    a wider stacked axis (`core.stacked_rtrl`); `col_mask` spans the full
    width."""
    n, m = layout.n, layout.m
    ref = mbar["v_g"] if cfg.kind == "rnn" else mbar["u_g"]
    B = ref.shape[0]
    idx = torch.arange(n, device=ref.device)

    def diag_block(coef, g):
        M4 = ref.new_zeros((B, n, n, m))
        M4[:, idx, idx] = coef[:, :, None] * g[:, None, :]
        return M4.reshape(B, n, n * m)

    if cfg.kind == "rnn":
        blocks = [diag_block(mbar["v_diag_coef"], mbar["v_g"])]
    else:
        blocks = []
        for g in layout.gates:
            if g == "r":
                M4 = mbar["r_coef"][:, :, :, None] * mbar["r_g"][:, None, None, :]
                blocks.append(M4.reshape(B, n, n * m))
            else:
                blocks.append(diag_block(mbar[f"{g}_diag_coef"],
                                         mbar[f"{g}_g"]))
        blocks.append(-torch.eye(n, device=ref.device)[None].expand(B, n, n))
    return _place(layout, torch.cat(blocks, dim=-1), col_mask, offset,
                  total_pad)


def flat_mbar_rows(cfg: EGRUConfig, layout: FlatLayout, mbar: Tree,
                   safe_new: torch.Tensor,
                   col_mask: torch.Tensor | None = None, *, offset: int = 0,
                   total_pad: int | None = None) -> torch.Tensor:
    """M-bar rows gathered at the active row indices: [B, K, total_pad]
    (hp-ungated), the full-width M-bar of the compact backends.

    The dense [B, n, P] immediate influence is never built; dead slots
    (safe_new clamped) give rows that the caller gates to zero through
    hp.  Each slot's unit is written by index assignment (one slot, one
    unit), deterministic on CUDA."""
    n, m = layout.n, layout.m
    B, K = safe_new.shape
    rows = safe_new.long()
    bidx = torch.arange(B, device=rows.device)[:, None]
    slot = torch.arange(K, device=rows.device)[None, :]
    ref = mbar["v_g"] if cfg.kind == "rnn" else mbar["u_g"]

    def diag_block(coef, g):
        M4 = ref.new_zeros((B, K, n, m))
        M4[bidx, slot, rows] = coef[bidx, rows][:, :, None] * g[:, None, :]
        return M4.reshape(B, K, n * m)

    if cfg.kind == "rnn":
        blocks = [diag_block(mbar["v_diag_coef"], mbar["v_g"])]
    else:
        blocks = []
        for g in layout.gates:
            if g == "r":
                coef = mbar["r_coef"][bidx, rows]               # [B, K, n]
                M4 = coef[:, :, :, None] * mbar["r_g"][:, None, None, :]
                blocks.append(M4.reshape(B, K, n * m))
            else:
                blocks.append(diag_block(mbar[f"{g}_diag_coef"],
                                         mbar[f"{g}_g"]))
        th = ref.new_zeros((B, K, n))
        th[bidx, slot, rows] = -1.0
        blocks.append(th)
    return _place(layout, torch.cat(blocks, dim=-1), col_mask, offset,
                  total_pad)


def unflatten_flat_grads(cfg: EGRUConfig, layout: FlatLayout,
                         gw: torch.Tensor) -> Tree:
    """Flat gradient [P_pad] -> recurrent parameter tree (inverse layout)."""
    n, n_in, m = layout.n, layout.n_in, layout.m
    out: dict = {}
    for i, g in enumerate(layout.gates):
        gq = gw[i * n * m:(i + 1) * n * m].reshape(n, m)        # [q, m]
        out[g] = {"W": gq[:, :n_in].T, "R": gq[:, n_in:n_in + n].T,
                  "b": gq[:, n_in + n]}
        if cfg.kind == "rnn":
            out["theta"] = gq[:, -1]
    if cfg.kind != "rnn":
        out["theta"] = gw[layout.theta_offset:layout.theta_offset + layout.n]
    return out


# ---------------------------------------------------------------------------
# One "pallas" step: the dense flat carry [B, n, P_carry]
# ---------------------------------------------------------------------------

def pallas_step_operands(cfg: EGRUConfig, w: Tree, layout: FlatLayout,
                         a_prev: torch.Tensor, M: torch.Tensor,
                         x_t: torch.Tensor, *, cl: ColLayout | None,
                         col_mask: torch.Tensor | None,
                         jmask: torch.Tensor | None, layer: int = 0,
                         offset: int = 0, total_pad: int | None = None,
                         M_below: torch.Tensor | None = None):
    """Everything of one dense-flat-carry step up to the update (backends
    "pallas" and, in the stacked engine, "dense").

    Returns (a_new, hp, operands) where `operands` is the argument tuple of
    `kernels.ops.influence_update`: (hp, J-hat, M, M-bar, jmask, col_mask).
    col_mask is the column liveness of the carry's axis: on the full-width
    axis it also zeroes M-bar's dead columns, `offset`/`total_pad` placing
    the layer's columns in a stacked axis; with `cl` the carry is
    column-compact and M-bar is built at Pc_pad for `layer`'s columns.
    With `M_below` (a stacked layer l >= 1) the cross term B-hat M^(l-1)_t
    is added to M-bar in f32 before the update."""
    a_new, hp, Jhat, Bhat, mbar = _partials(cfg, w, a_prev, x_t, M_below)
    if cl is not None:
        Mbar = flat_mbar_cols(cfg, layout, cl, mbar, layer=layer)
    else:
        Mbar = flat_mbar(cfg, layout, mbar, col_mask, offset=offset,
                         total_pad=total_pad)
    if M_below is not None:
        Mbar = Mbar + torch.bmm(Bhat, M_below)
    return a_new, hp, (hp, Jhat, M, Mbar, jmask, col_mask)


# ---------------------------------------------------------------------------
# One compact RTRL step (row-compact, column-compact with `cl`)
# ---------------------------------------------------------------------------

def _partials(cfg: EGRUConfig, w: Tree, a_prev, x_t, below):
    """(a_new, hp, J-hat, B-hat or None, mbar): the input Jacobian only
    where a layer below feeds the cross term."""
    if below is None:
        a_new, hp, Jhat, mbar = cell_partials(cfg, w, a_prev, x_t)
        return a_new, hp, Jhat, None, mbar
    return cell_partials_full(cfg, w, a_prev, x_t)


def _cross_term(cfg: EGRUConfig, w: Tree, Bhat, idx_new, below):
    """B^(l) M^(l-1)_t at the new rows: the B-hat tiles gathered at (new
    rows, active rows of the layer below) times the layer below's fresh
    compact carry, in f32 (a bf16 carry is read as f32).  For kind="rnn"
    B-hat = W^T, looked up from W."""
    vals_b, idx_b = below
    AT = w["v"]["W"] if cfg.kind == "rnn" else None
    Bgg = CK.gather_tiles(None if AT is not None else Bhat, idx_new, idx_b,
                          AT=AT)
    return torch.bmm(Bgg, vals_b.float())


def flat_compact_step(cfg: EGRUConfig, w: Tree, layout: FlatLayout,
                      a_prev: torch.Tensor, vals: torch.Tensor,
                      idx_prev: torch.Tensor, x_t: torch.Tensor,
                      col_mask: torch.Tensor | None = None, *,
                      offset: int = 0, total_pad: int | None = None,
                      below: tuple | None = None,
                      cl: ColLayout | None = None, layer: int = 0):
    """One RTRL step with the influence carried row-compact (backend
    "compact"): vals [B, K, total_pad], idx_prev [B, K] (-1 = dead slot).
    Returns (a_new, hp, vals', idx', count, overflow).  The update costs
    K * K_prev * P.

    Stacked networks (`core.stacked_rtrl`): `offset`/`total_pad` place this
    layer's M-bar columns inside the stacked parameter axis, and
    `below=(vals_below, idx_below)` adds the cross-layer term
    B^(l) M^(l-1)_t, x_t then being the layer below's activity a^{l-1}_t;
    the B-hat tiles are gathered at (new rows, active rows of the layer
    below), so the cross term costs K * K_below * P.

    DUAL compaction: with `cl` the parameter axis is the compact one of
    `cl` ([B, K, Pc_pad]), M-bar is built directly at that width (`layer`
    names this layer's columns of a stacked axis) and
    col_mask/offset/total_pad are not read (liveness and placement live in
    `cl`)."""
    n, K = layout.n, idx_prev.shape[1]
    a_new, hp, Jhat, Bhat, mbar = _partials(cfg, w, a_prev, x_t, below)
    idx_new, count = CK.compact_rows(hp != 0.0, K)
    safe_new = idx_new.clamp(0, n - 1)
    live_new = idx_new >= 0
    # rnn J-hat = R^T: look tiles up straight from R, never building [B, n, n]
    R = w["v"]["R"] if cfg.kind == "rnn" else None
    Jgg = CK.gather_j_tiles(None if R is not None else Jhat,
                            idx_new, idx_prev, R=R)
    if cl is not None:
        mbar_rows = flat_mbar_rows_cols(cfg, layout, cl, mbar, safe_new,
                                        layer=layer)
    else:
        mbar_rows = flat_mbar_rows(cfg, layout, mbar, safe_new, col_mask,
                                   offset=offset, total_pad=total_pad)
    if below is not None:
        mbar_rows = mbar_rows + _cross_term(cfg, w, Bhat, idx_new, below)
    hp_rows = hp.gather(1, safe_new.long()) * live_new
    Mc, overflow = CK.compact_update(Jgg, vals, mbar_rows, hp_rows,
                                     idx_new, count, K)
    return a_new, hp, Mc.vals, Mc.idx, Mc.count, overflow


def fused_step_operands(cfg: EGRUConfig, w: Tree, layout: FlatLayout,
                        a_prev: torch.Tensor, vals: torch.Tensor,
                        idx_prev: torch.Tensor, x_t: torch.Tensor, *,
                        cl: ColLayout, layer: int = 0,
                        below: tuple | None = None):
    """Everything of one fused step up to the kernel launch.

    Returns (a_new, hp, operands, overflow) where `operands` is the
    argument tuple of `compact_fused.fused_update`: (J-hat [B,n,n] f32,
    vals, mbar_rows [B,K,Pc_pad] f32, hp_rows [B,K] f32, idx_new,
    idx_prev, count_new, count_prev), indices and counts int32.  With
    `below` (a stacked layer l >= 1) the cross term B^(l) M^(l-1)_t is
    folded into mbar_rows in f32 before the launch, as the JAX package's
    kernel path does; the kernel is the same."""
    n, K = layout.n, idx_prev.shape[1]
    a_new, hp, Jhat, Bhat, mbar = _partials(cfg, w, a_prev, x_t, below)
    idx_new, count = CK.compact_rows(hp != 0.0, K)
    safe_new = idx_new.clamp(0, n - 1)
    hp_rows = hp.gather(1, safe_new.long()) * (idx_new >= 0)
    count_prev = (idx_prev >= 0).sum(dim=1).int()
    overflow = (count - K).clamp(min=0)
    count_new = count.clamp(max=K)
    # the kernel gathers its tiles from the dense J-hat (rnn: R^T broadcast)
    mbar_rows = flat_mbar_rows_cols(cfg, layout, cl, mbar, safe_new,
                                    layer=layer)
    if below is not None:
        mbar_rows = mbar_rows + _cross_term(cfg, w, Bhat, idx_new, below)
    operands = (Jhat.float().contiguous(), vals, mbar_rows.contiguous(),
                hp_rows.contiguous(), idx_new, idx_prev.int().contiguous(),
                count_new, count_prev)
    return a_new, hp, operands, overflow


def flat_compact_fused_step(cfg: EGRUConfig, w: Tree, layout: FlatLayout,
                            a_prev: torch.Tensor, vals: torch.Tensor,
                            idx_prev: torch.Tensor, x_t: torch.Tensor, *,
                            cl: ColLayout, layer: int = 0,
                            below: tuple | None = None):
    """`flat_compact_step`, fused (backend "compact_fused"): the J-tile
    gather, the [K x K'] x [K' x Pc] contraction, the M-bar add and the hp
    diagonal scale run as ONE kernel launch with capacity ragged PER
    EXAMPLE (`kernels.compact_fused.fused_update`: the CUDA kernel on the
    card, its plain PyTorch version on the CPU).  Same contract and returns
    as the dual-compact `flat_compact_step` (`cl` required)."""
    a_new, hp, ops, overflow = fused_step_operands(
        cfg, w, layout, a_prev, vals, idx_prev, x_t, cl=cl, layer=layer,
        below=below)
    new_vals = CF.fused_update(*ops)
    idx_new, count_new = ops[4], ops[6]
    return a_new, hp, new_vals, idx_new, count_new, overflow


def capacity_K(n: int, capacity: float) -> int:
    """Static row capacity: ceil(capacity * n), 8-aligned, capped at n."""
    return max(8, min(n, -(-int(math.ceil(capacity * n)) // 8) * 8))


BACKENDS = ("dense", "pallas", "compact", "compact_fused")


def sparse_rtrl_loss_and_grads(cfg: EGRUConfig, params: Tree,
                               xs: torch.Tensor, labels: torch.Tensor,
                               masks: Tree | None = None, *,
                               backend: str = "dense", capacity: float = 1.0,
                               col_compact: bool | None = None,
                               influence_dtype: str = "float32"):
    """Structured exact RTRL over a whole sequence xs [T, B, n_in] with a
    fixed label.  Returns (loss, grads, stats), every stat stacked over T.

    A thin scan over the streaming learner (`core.learner.SparseLearner`),
    so the per-step engine is the one online training runs."""
    from repro_torch.core.learner import LearnerSpec, make_learner, scan_learner
    learner = make_learner(LearnerSpec(
        engine="sparse", cfg=cfg, backend=backend, capacity=capacity,
        col_compact=col_compact, influence_dtype=influence_dtype))
    return scan_learner(learner, params, masks, xs, labels)
