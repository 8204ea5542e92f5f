"""Public wrappers of the block-sparse kernels, and their block accounting.

Counterpart of `repro.kernels.ops`.  `influence_update` pads the operands
to the kernel's block multiples (8 rows, 128 columns), derives the four
block masks (or takes the two constant ones from `constant_block_masks`,
built once for a run), hands them to `kernels.influence.influence_update`
(the CUDA kernel on CUDA tensors, its plain version on CPU tensors) and
crops the result back.  `event_matmul` does the same for
`kernels.event_matmul.event_matmul`: pads a to 8 columns and R to 8 rows
and 128 columns, takes the activity blocks of a and the parameter blocks of
an optional rmask, and crops.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import event_matmul as EM, influence as IN


def _pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return torch.nn.functional.pad(x, widths)


def constant_block_masks(n, P, jmask=None, col_mask=None, *, device):
    """The two block masks that the parameter masks fix for a whole run, of
    operands [B, n, P] padded to the kernel's blocks: int32 (col_blocks,
    j_blocks).  jmask and col_mask as in `influence_update`.  Hand them to
    `influence_update` as `block_masks`, so a step builds only row_mask and
    prev_mask."""
    n_p, P_p = n + (-n) % IN.BK, P + (-P) % IN.BP
    return tuple(t.contiguous() for t in IN.constant_block_masks(
        col_mask, jmask, n_p, P_p, device))


def influence_operands(hp, Jhat, M, Mbar, jmask=None, col_mask=None, *,
                       block_masks=None):
    """The kernel's padded, contiguous operands and block masks:
    (hp_p, J_p, M_p, Mbar_p, row_mask, prev_mask, col_blocks, j_blocks).

    hp [B, n]; Jhat [B, n, n]; M, Mbar [B, n, P]; jmask an optional [n, n]
    J pattern in R layout ([l, k]); col_mask an optional [P] column
    liveness.  block_masks, if given, is `constant_block_masks` of the same
    n, P, jmask and col_mask, which are then not read."""
    hp_p = _pad_to(hp, IN.BK, 1)
    J_p = _pad_to(_pad_to(Jhat, IN.BK, 1), IN.BL, 2)
    M_p = _pad_to(_pad_to(M, IN.BL, 1), IN.BP, 2)
    Mb_p = _pad_to(_pad_to(Mbar, IN.BK, 1), IN.BP, 2)
    if block_masks is None:
        masks = IN.build_block_masks(hp_p, M_p, col_mask, jmask)
    else:
        masks = (*IN.step_block_masks(hp_p, M_p), *block_masks)
    return tuple(t.contiguous() for t in (hp_p, J_p, M_p, Mb_p, *masks))


def influence_update(hp, Jhat, M, Mbar, jmask=None, col_mask=None, *,
                     block_masks=None):
    """Block-sparse M_t = D(hp)[Jhat M_{t-1} + Mbar].

    hp: [B,n]; Jhat: [B,n,n]; M, Mbar: [B,n,P] float32.  jmask: optional
    [n,n] J pattern (R layout); col_mask: optional [P] parameter-column
    liveness; block_masks: optional `constant_block_masks(n, P, jmask,
    col_mask)`, built once for a run.  Shapes are padded internally; the
    result is cropped back."""
    B, n, P = M.shape
    hp_p, J_p, M_p, Mb_p, row, prev, cols, jm = influence_operands(
        hp, Jhat, M, Mbar, jmask, col_mask, block_masks=block_masks)
    out = IN.influence_update(hp_p, J_p, M_p, Mb_p, row_mask=row,
                              prev_mask=prev, col_mask=cols, jmask=jm)
    return out[:, :n, :P]


def event_matmul_operands(a, R, rmask=None):
    """The kernel's padded, contiguous operands and block masks:
    (a_p, R_p, act_mask, rmask_blocks).  a [B, n]; R [n, m]; rmask an
    optional [n, m] parameter mask, cast to int32 as the reference does (a
    block is live where any entry is non-zero after the cast)."""
    a_p = _pad_to(a, EM.BL, 1)
    R_p = _pad_to(_pad_to(R, EM.BL, 0), EM.BM, 1)
    n_p, m_p = R_p.shape
    act = IN.block_any(a_p, EM.BL, axis=1)
    if rmask is None:
        rm = torch.ones((n_p // EM.BL, m_p // EM.BM), dtype=torch.int32,
                        device=R.device)
    else:
        rm = _pad_to(_pad_to(rmask.int(), EM.BL, 0), EM.BM, 1)
        rm = (rm.reshape(n_p // EM.BL, EM.BL, m_p // EM.BM, EM.BM) != 0).any(
            dim=3).any(dim=1).int()
    return tuple(t.contiguous() for t in (a_p, R_p, act, rm))


def event_matmul(a, R, rmask=None):
    """Activity-sparse y = a @ R. a: [B,n]; R: [n,m], one dtype (f32 or
    bf16); rmask: optional [n,m] parameter mask.  The result, in R's dtype,
    is cropped back to [B, m]."""
    m = R.shape[1]
    a_p, R_p, act, rm = event_matmul_operands(a, R, rmask)
    return EM.event_matmul(a_p, R_p, act_mask=act, rmask=rm)[:, :m]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _pad_np(x: np.ndarray, mult: int, axis: int) -> np.ndarray:
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, (-x.shape[axis]) % mult)
    return np.pad(x, widths)


def _block_any_np(x: np.ndarray, block: int, axis: int) -> np.ndarray:
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // block, block]
    return np.any(x.reshape(shape) != 0, axis=axis + 1).astype(np.int32)


def realized_block_savings(hp, M_prev, jmask, col_mask, *, bk=8, bl=8,
                           bp=128) -> float:
    """Fraction of [bk x bl x bp] work blocks actually executed — the
    block-granular counterpart of the paper's  w~^2 b~(t) b~(t-1)  factor.
    Host numpy, in the reference's order of operations, so the two agree
    exactly; times B * n_kb * n_lb * n_pb it is the kernel's block count."""
    hp, M_prev = _np(hp), _np(M_prev)
    B = hp.shape[0]
    row = _block_any_np(_pad_np(hp, bk, 1), bk, 1)                  # [B,nkb]
    prev = _block_any_np(np.any(_pad_np(M_prev, bl, 1) != 0, axis=2)
                         .astype(np.int32), bl, 1)
    nkb, nlb = row.shape[1], prev.shape[1]
    if jmask is not None:
        jm = _np(jmask).T.astype(bool)
        jm = np.add.reduceat(np.add.reduceat(
            jm, np.arange(0, jm.shape[0], bk), 0),
            np.arange(0, jm.shape[1], bl), 1) > 0
    else:
        jm = np.ones((nkb, nlb), bool)
    if col_mask is None:
        col_frac = 1.0
    else:
        cm = _np(col_mask)
        col_frac = float(np.mean(
            np.add.reduceat(cm, np.arange(0, cm.shape[0], bp)) > 0))
    executed = 0.0
    for b in range(B):
        executed += float((row[b][:, None] * prev[b][None, :] * jm).mean())
    return executed / B * col_frac
