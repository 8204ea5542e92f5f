"""Block-sparse RTRL influence update on the dense flat carry: one kernel
launch per step.

    out[b] = D(hp[b]) . ( J-hat[b] @ M[b] + M-bar[b] )        (paper Eq. 10)

Counterpart of `repro.kernels.influence`: the backend-"pallas" hot path.
Operands are pre-padded (`kernels.ops` pads): hp [B, n_p], J-hat
[B, n_p, n_p], M and M-bar [B, n_p, P_p] f32 with n_p % 8 == 0 and
P_p % 128 == 0.  Four int32 block masks realise the paper's sparsity
factors at block granularity:

  row_mask  [B, n_p/8]        beta(t): 8-row output blocks with H' = 0
                              (written as exact zeros)
  prev_mask [B, n_p/8]        beta(t-1): l-blocks whose rows of M are zero
                              (skipped in the contraction)
  col_mask  [P_p/128]         omega: column blocks the masks kill (zeros)
  jmask     [n_p/8, n_p/8]    omega on J: J-hat blocks [kb, lb] outside
                              the pattern (skipped)

  * `influence_update` — the wrapper.  On CUDA tensors it launches the
    hand-written kernel (`csrc/influence.cu`, built at first use by
    `kernels._build`) or raises; on CPU tensors it runs
    `influence_reference`.  `influence_update.launches` counts launches.
  * `influence_reference` — the plain PyTorch version, applying the four
    block masks explicitly, so it equals the kernel on any inputs; on
    inputs whose masks are derived from them (`build_block_masks`) it
    equals `ref.influence_ref`.
  * `block_any`, `build_block_masks`, `executed_blocks` — the masks, and
    the count of (b, kb, lb, pb) blocks they leave to multiply.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

BK = BL = 8        # rows of an output block / of an l-block
BP = 128           # columns of a block


def block_any(x: torch.Tensor, block: int, axis: int) -> torch.Tensor:
    """Block-activity indicator along `axis` (int32 0/1)."""
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // block, block]
    return (x.reshape(shape) != 0).any(dim=axis + 1).int()


def build_block_masks(hp_p, M_p, col_mask, jmask, *, bk: int = BK,
                      bl: int = BL, bp: int = BP):
    """The four per-step block masks of the padded operands (hp_p [B, n_p],
    M_p [B, n_p, P_p]); col_mask is the [P] column liveness and jmask the
    [n, n] J pattern in R layout ([l, k], as `flat_jmask` returns it), both
    optional and unpadded.  Returns int32 (row_mask [B, n_p/bk], prev_mask
    [B, n_p/bl], col_blocks [P_p/bp], j_blocks [n_p/bk, n_p/bl]).

    j_blocks is indexed [kb, lb] like J-hat itself, hence the transpose of
    the [l, k] pattern."""
    n_p, P_p = M_p.shape[1], M_p.shape[2]
    dev = M_p.device
    row_mask = block_any(hp_p, bk, axis=1)
    prev_mask = block_any((M_p != 0).any(dim=2).int(), bl, axis=1)
    if col_mask is None:
        col_blocks = torch.ones((P_p // bp,), dtype=torch.int32, device=dev)
    else:
        cm = torch.nn.functional.pad(col_mask.int(), (0, P_p - col_mask.shape[0]))
        col_blocks = block_any(cm[None], bp, axis=1)[0]
    if jmask is None:
        j_blocks = torch.ones((n_p // bk, n_p // bl), dtype=torch.int32,
                              device=dev)
    else:
        jmT = jmask.T.int()                                 # [k, l]
        jmT = torch.nn.functional.pad(
            jmT, (0, n_p - jmT.shape[1], 0, n_p - jmT.shape[0]))
        j_blocks = (jmT.reshape(n_p // bk, bk, n_p // bl, bl) != 0).any(
            dim=3).any(dim=1).int()
    return row_mask, prev_mask, col_blocks, j_blocks


def executed_blocks(row_mask, prev_mask, col_mask, jmask) -> torch.Tensor:
    """Number of (b, kb, lb, pb) blocks the kernel multiplies (int64)."""
    per_b = torch.einsum("bk,bl,kl->b", (row_mask != 0).double(),
                         (prev_mask != 0).double(), (jmask != 0).double())
    return (per_b.sum() * (col_mask != 0).sum()).round().long()


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _expand(mask, block, dim):
    return (mask != 0).repeat_interleave(block, dim=dim)


def influence_reference(hp, Jhat, M, Mbar, *, row_mask, prev_mask, col_mask,
                        jmask):
    """Plain PyTorch version: J-hat zeroed outside the live (prev, j)
    blocks, M's rows of dead previous blocks ignored, hp * (J-hat @ M +
    M-bar), dead row and column blocks exactly zero.  f32 result."""
    keep_l = _expand(prev_mask, BL, 1)                          # [B, n_p]
    keep_j = _expand(_expand(jmask, BK, 0), BL, 1)              # [n_p, n_p]
    J = torch.where(keep_j[None] & keep_l[:, None, :], Jhat.float(), 0.0)
    Mv = torch.where(keep_l[:, :, None], M.float(), 0.0)
    out = hp.float()[:, :, None] * (torch.bmm(J, Mv) + Mbar.float())
    live = _expand(row_mask, BK, 1)[:, :, None] & _expand(col_mask, BP, 0)
    return torch.where(live, out, 0.0)


# ---------------------------------------------------------------------------
# The wrapper: the CUDA kernel on the card, the plain version on the CPU
# ---------------------------------------------------------------------------

def influence_update(hp, Jhat, M, Mbar, *, row_mask, prev_mask, col_mask,
                     jmask, block_count: torch.Tensor | None = None):
    """One block-sparse influence update on padded operands (see the module
    docstring); returns out [B, n_p, P_p] f32.

    block_count, if given, is a [1] int64 tensor on the operands' device to
    which the number of executed (b, kb, lb, pb) blocks is added.

    CPU tensors go to `influence_reference`; CUDA tensors launch the kernel
    (one launch, counted in `influence_update.launches`) or raise."""
    masks = dict(row_mask=row_mask, prev_mask=prev_mask, col_mask=col_mask,
                 jmask=jmask)
    if M.device.type == "cpu":
        if block_count is not None:
            block_count += executed_blocks(**masks)
        return influence_reference(hp, Jhat, M, Mbar, **masks)
    if M.device.type != "cuda":
        raise ValueError(f"influence_update: no kernel for device {M.device}")
    B, n, P = M.shape
    if n % BK or P % BP:
        raise ValueError(f"influence_update: padded shapes need n % {BK} == 0 "
                         f"and P % {BP} == 0, got n={n}, P={P}")
    f32, i32 = (torch.float32,), (torch.int32,)
    for name, t, dtypes, shape in (
            ("M", M, f32, (B, n, P)),
            ("Mbar", Mbar, f32, (B, n, P)),
            ("Jhat", Jhat, f32, (B, n, n)),
            ("hp", hp, f32, (B, n)),
            ("row_mask", row_mask, i32, (B, n // BK)),
            ("prev_mask", prev_mask, i32, (B, n // BL)),
            ("col_mask", col_mask, i32, (P // BP,)),
            ("jmask", jmask, i32, (n // BK, n // BL)),
            ("block_count", block_count, (torch.int64,), (1,))):
        if t is not None:
            _build.check_operand("influence_update", name, t, dtypes, shape,
                                 M.device)
    args = [hp, Jhat, M, Mbar, row_mask, prev_mask, col_mask, jmask]
    out = torch.empty_like(M)
    lib = _build.load("influence")
    stream = torch.cuda.current_stream(M.device).cuda_stream
    counter = None if block_count is None else block_count.data_ptr()
    with torch.cuda.device(M.device):
        err = lib.repro_influence_update(
            *(ctypes.c_void_p(t.data_ptr()) for t in args[:8]),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(counter),
            B, n, P, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"influence_update: kernel launch failed: "
                           f"{_build.error_string(lib, err)}")
    influence_update.launches += 1
    return out


influence_update.launches = 0
