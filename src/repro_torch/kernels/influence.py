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
  * `block_any`, `build_block_masks` (= `step_block_masks`, rebuilt every
    step, + `constant_block_masks`, fixed by the parameter masks),
    `executed_blocks` — the masks, and the count of (b, kb, lb, pb) blocks
    they leave to multiply.
  * `empty_launch` — an empty kernel through the same route: the launch
    floor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import fold, is_transformed

BK = BL = 8        # rows of an output block / of an l-block
BP = 128           # columns of a block


def block_any(x: torch.Tensor, block: int, axis: int) -> torch.Tensor:
    """Block-activity indicator along `axis` (int32 0/1)."""
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // block, block]
    return (x.reshape(shape) != 0).any(dim=axis + 1).int()


def step_block_masks(hp_p, M_p, *, bk: int = BK, bl: int = BL):
    """The two block masks that change every step, of the padded operands
    (hp_p [B, n_p], M_p [B, n_p, P_p]): int32 (row_mask [B, n_p/bk],
    prev_mask [B, n_p/bl])."""
    row_mask = block_any(hp_p, bk, axis=1)
    prev_mask = block_any((M_p != 0).any(dim=2).int(), bl, axis=1)
    return row_mask, prev_mask


def constant_block_masks(col_mask, jmask, n_p: int, P_p: int, device, *,
                         bk: int = BK, bl: int = BL, bp: int = BP):
    """The two block masks fixed by the parameter masks, for operands
    padded to n_p rows and P_p columns: col_mask is the [P] column liveness
    and jmask the [n, n] J pattern in R layout ([l, k], as `flat_jmask`
    returns it), both optional and unpadded.  Returns int32 (col_blocks
    [P_p/bp], j_blocks [n_p/bk, n_p/bl]).

    j_blocks is indexed [kb, lb] like J-hat itself, hence the transpose of
    the [l, k] pattern."""
    if col_mask is None:
        col_blocks = torch.ones((P_p // bp,), dtype=torch.int32, device=device)
    else:
        cm = torch.nn.functional.pad(col_mask.int(), (0, P_p - col_mask.shape[0]))
        col_blocks = block_any(cm[None], bp, axis=1)[0]
    if jmask is None:
        j_blocks = torch.ones((n_p // bk, n_p // bl), dtype=torch.int32,
                              device=device)
    else:
        jmT = jmask.T.int()                                 # [k, l]
        jmT = torch.nn.functional.pad(
            jmT, (0, n_p - jmT.shape[1], 0, n_p - jmT.shape[0]))
        j_blocks = (jmT.reshape(n_p // bk, bk, n_p // bl, bl) != 0).any(
            dim=3).any(dim=1).int()
    return col_blocks, j_blocks


def build_block_masks(hp_p, M_p, col_mask, jmask, *, bk: int = BK,
                      bl: int = BL, bp: int = BP):
    """The four per-step block masks of the padded operands (hp_p [B, n_p],
    M_p [B, n_p, P_p]); col_mask and jmask as in `constant_block_masks`.
    Returns int32 (row_mask [B, n_p/bk], prev_mask [B, n_p/bl], col_blocks
    [P_p/bp], j_blocks [n_p/bk, n_p/bl])."""
    n_p, P_p = M_p.shape[1], M_p.shape[2]
    return (*step_block_masks(hp_p, M_p, bk=bk, bl=bl),
            *constant_block_masks(col_mask, jmask, n_p, P_p, M_p.device,
                                  bk=bk, bl=bl, bp=bp))


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

_CALLS: dict = {}
_last: list = [None]        # the last call's KernelCall, tried first


def _call(B, n, P, device, counted) -> _build.KernelCall:
    """The kernel's launch at these shapes, built once."""
    key = (B, n, P, device, counted)
    call = _CALLS.get(key)
    if call is None:
        f32, i32 = torch.float32, torch.int32
        entries = [("hp", f32, (f32,), (B, n)),
                   ("Jhat", f32, (f32,), (B, n, n)),
                   ("M", f32, (f32,), (B, n, P)),
                   ("Mbar", f32, (f32,), (B, n, P)),
                   ("row_mask", i32, (i32,), (B, n // BK)),
                   ("prev_mask", i32, (i32,), (B, n // BL)),
                   ("col_mask", i32, (i32,), (P // BP,)),
                   ("jmask", i32, (i32,), (n // BK, n // BL))]
        if counted:
            entries.append(("block_count", torch.int64, (torch.int64,), (1,)))
        lib = _build.load("influence")
        call = _CALLS[key] = _build.KernelCall(
            "influence_update", device, entries, lib,
            lib.repro_influence_update, (B, n, P), n_ptrs=10)
    return call


def influence_update(hp, Jhat, M, Mbar, *, row_mask, prev_mask, col_mask,
                     jmask, block_count: torch.Tensor | None = None):
    """One block-sparse influence update on padded operands (see the module
    docstring); returns out [B, n_p, P_p] f32.

    block_count, if given, is a [1] int64 tensor on the operands' device to
    which the number of executed (b, kb, lb, pb) blocks is added.

    CPU tensors go to `influence_reference`; CUDA tensors launch the kernel
    (one launch, counted in `influence_update.launches`) or raise.  The
    float operands must be 16-byte aligned (the kernel copies 16 bytes at a
    time); a fresh or padded tensor is.  The operands are checked in one
    comparison per tensor against the last call's shapes; only where that
    fails are the shapes looked at again.  The kernel has no backward: a
    float operand that requires grad under grad mode raises.

    Under `torch.func.vmap` (the stream fleet) the slots fold into the
    example axis (`kernels._build.fold`): one launch for every slot,
    counted once, with col_mask, jmask and block_count shared by every
    slot (the counter then adds the blocks of all of them)."""
    args = (hp, Jhat, M, Mbar, row_mask, prev_mask, col_mask, jmask)
    if block_count is not None:
        args += (block_count,)
    call = _last[0]
    if call is None or not call.matches(args):
        if is_transformed(M):
            return _fold(hp, Jhat, M, Mbar, row_mask, prev_mask, col_mask,
                         jmask, block_count)
        dev = M.device
        if dev.type == "cpu":
            masks = dict(row_mask=row_mask, prev_mask=prev_mask,
                         col_mask=col_mask, jmask=jmask)
            if block_count is not None:
                block_count += executed_blocks(**masks)
            return influence_reference(hp, Jhat, M, Mbar, **masks)
        if dev.type != "cuda":
            raise ValueError(f"influence_update: no kernel for device {dev}")
        B, n, P = M.shape
        if n % BK or P % BP:
            raise ValueError(f"influence_update: padded shapes need n % {BK} "
                             f"== 0 and P % {BP} == 0, got n={n}, P={P}")
        call = _call(B, n, P, dev, block_count is not None)
        call.check(args)
        _last[0] = call
    _build.refuse_autograd("influence_update", hp, Jhat, M, Mbar)
    try:
        ptrs = list(map(torch.Tensor.data_ptr, args))
    except RuntimeError:
        # a vmapped slot has no storage, and its shapes can match the last
        # call's: only here, off the unbatched call's path, is it folded
        if is_transformed(M):
            return _fold(hp, Jhat, M, Mbar, row_mask, prev_mask, col_mask,
                         jmask, block_count)
        raise
    if (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) & 15:
        raise ValueError("influence_update: hp, Jhat, M and Mbar must be "
                         "16-byte aligned")
    out = torch.empty_like(M)
    call.launch(*ptrs[:8], out.data_ptr(),
                ptrs[8] if block_count is not None else 0)
    influence_update.launches += 1
    return out


influence_update.launches = 0


def _folded_update(hp, Jhat, M, Mbar, row_mask, prev_mask, col_mask, jmask,
                   block_count):
    """`influence_update` with every operand positional (the fold's call)."""
    return influence_update(hp, Jhat, M, Mbar, row_mask=row_mask,
                            prev_mask=prev_mask, col_mask=col_mask,
                            jmask=jmask, block_count=block_count)


def _fold(*args):
    """One launch for every slot of a vmapped call: the masks and the block
    counter shared, the rest folded into the examples."""
    return fold(_folded_update, args, shared=(6, 7, 8))


def empty_launch(device) -> None:
    """Launch an empty kernel through the same route as `influence_update`
    (packed arguments, driver API; no operands, no check): the launch floor
    any wrapper of this route pays.  Not counted."""
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    call = _CALLS.get(("empty", device))
    if call is None:
        lib = _build.load("influence")
        call = _CALLS[("empty", device)] = _build.KernelCall(
            "empty_launch", device, [], lib, lib.repro_empty_launch, (),
            n_ptrs=0)
    call.launch()
