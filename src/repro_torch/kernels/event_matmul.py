"""Event-driven (activity-sparse) matmul: y[b] = a[b] @ R with block skips.

Counterpart of `repro.kernels.event_matmul` (kernel K3), the paper's
forward-pass term (alpha~ n^2 instead of n^2).  Operands are pre-padded
(`kernels.ops.event_matmul` pads): a [B, n], R [n, m], both f32 or both
bf16, n % 8 == 0 and m % 128 == 0.  Two int32 block masks name the work to
skip:

  act_mask [B, n/8]       8-wide blocks of a[b] with no event (all zero)
  rmask    [n/8, m/128]   8 x 128 blocks of R the parameter mask kills

A (b, lb, mb) block is multiplied only where both are non-zero; the sum is
f32 and the output has R's dtype.

  * `event_matmul` — the wrapper.  On CUDA tensors it launches the
    hand-written kernel (`csrc/event_matmul.cu`, built at first use by
    `kernels._build`) or raises; on CPU tensors it runs
    `event_matmul_reference`.  `event_matmul.launches` counts launches.
  * `event_matmul_reference` — the plain PyTorch version, applying both
    block masks explicitly, so it equals the kernel also on masks not
    derived from the operands.
  * `executed_blocks` — the number of (b, lb, mb) blocks the masks leave.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

BL = 8             # rows of an l-block of R (and width of a block of a)
BM = 128           # columns of a block of R


def executed_blocks(act_mask, rmask) -> torch.Tensor:
    """sum_b sum_lb sum_mb act_mask[b, lb] * rmask[lb, mb] (int64)."""
    per_b = (act_mask != 0).double() @ (rmask != 0).double()
    return per_b.sum().round().long()


def event_matmul_reference(a, R, *, act_mask, rmask):
    """Plain PyTorch version: a zeroed outside its live blocks, R outside
    the live parameter blocks, one f32 product, cast to R's dtype."""
    keep_a = (act_mask != 0).repeat_interleave(BL, dim=1)                # [B, n]
    keep_R = (rmask != 0).repeat_interleave(BL, dim=0).repeat_interleave(
        BM, dim=1)                                                       # [n, m]
    y = torch.where(keep_a, a.float(), 0.0) @ torch.where(keep_R, R.float(), 0.0)
    return y.to(R.dtype)


_CALLS: dict = {}
_last: list = [None]        # the last call's KernelCall, tried first
_DTYPES = (torch.float32, torch.bfloat16)


def _call(B, n, m, dtype, device, counted) -> _build.KernelCall:
    """The kernel's launch at these shapes, built once; `dtype` is R's (a
    kernel dtype, or the entries' check raises on R)."""
    key = (B, n, m, dtype, device, counted)
    call = _CALLS.get(key)
    if call is None:
        i32 = torch.int32
        entries = [("R", dtype, _DTYPES, (n, m)),
                   ("a", dtype, (dtype,), (B, n)),
                   ("act_mask", i32, (i32,), (B, n // BL)),
                   ("rmask", i32, (i32,), (n // BL, m // BM))]
        if counted:
            entries.append(("block_count", torch.int64, (torch.int64,), (1,)))
        lib = _build.load("event_matmul")
        call = _CALLS[key] = _build.KernelCall(
            "event_matmul", device, entries, lib, lib.repro_event_matmul,
            (B, n, m, int(dtype == torch.bfloat16)), n_ptrs=6,
            out_like=torch.empty((B, m), dtype=dtype, device=device))
    return call


def event_matmul(a, R, *, act_mask, rmask,
                 block_count: torch.Tensor | None = None):
    """y = a @ R over the live blocks, on padded operands (see the module
    docstring); returns y [B, m] in R's dtype.

    block_count, if given, is a [1] int64 tensor on the operands' device to
    which the number of executed (b, lb, mb) blocks is added.

    CPU tensors go to `event_matmul_reference`; CUDA tensors launch the
    kernel (one launch, counted in `event_matmul.launches`) or raise.  a and
    R must be 16-byte aligned (the kernel copies 16 bytes at a time); a
    fresh or padded tensor is.  The operands are checked in one comparison
    per tensor against the last call's shapes; only where that fails are
    the shapes looked at again.  The kernel has no backward: a float
    operand that requires grad under grad mode raises."""
    args = (R, a, act_mask, rmask)
    if block_count is not None:
        args += (block_count,)
    call = _last[0]
    if call is None or not call.matches(args):
        dev = R.device
        if dev.type == "cpu":
            if block_count is not None:
                block_count += executed_blocks(act_mask, rmask)
            return event_matmul_reference(a, R, act_mask=act_mask, rmask=rmask)
        if dev.type != "cuda":
            raise ValueError(f"event_matmul: no kernel for device {dev}")
        B, n = a.shape
        m = R.shape[1]
        if n % BL or m % BM:
            raise ValueError(f"event_matmul: padded shapes need n % {BL} == 0 "
                             f"and m % {BM} == 0, got n={n}, m={m}")
        dtype = R.dtype if R.dtype in _DTYPES else torch.float32
        call = _call(B, n, m, dtype, dev, block_count is not None)
        call.check(args)
        _last[0] = call
    _build.refuse_autograd("event_matmul", a, R)
    ptrs = list(map(torch.Tensor.data_ptr, args))
    if (ptrs[0] | ptrs[1]) & 15:
        raise ValueError("event_matmul: a and R must be 16-byte aligned")
    y = torch.empty_like(call.out_like)
    call.launch(ptrs[1], ptrs[0], ptrs[2], ptrs[3], y.data_ptr(),
                ptrs[4] if block_count is not None else 0)
    event_matmul.launches += 1
    return y


event_matmul.launches = 0
