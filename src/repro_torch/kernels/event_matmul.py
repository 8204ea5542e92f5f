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

import ctypes

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


def event_matmul(a, R, *, act_mask, rmask,
                 block_count: torch.Tensor | None = None):
    """y = a @ R over the live blocks, on padded operands (see the module
    docstring); returns y [B, m] in R's dtype.

    block_count, if given, is a [1] int64 tensor on the operands' device to
    which the number of executed (b, lb, mb) blocks is added.

    CPU tensors go to `event_matmul_reference`; CUDA tensors launch the
    kernel (one launch, counted in `event_matmul.launches`) or raise."""
    if R.device.type == "cpu":
        if block_count is not None:
            block_count += executed_blocks(act_mask, rmask)
        return event_matmul_reference(a, R, act_mask=act_mask, rmask=rmask)
    if R.device.type != "cuda":
        raise ValueError(f"event_matmul: no kernel for device {R.device}")
    B, n = a.shape
    m = R.shape[1]
    if n % BL or m % BM:
        raise ValueError(f"event_matmul: padded shapes need n % {BL} == 0 and "
                         f"m % {BM} == 0, got n={n}, m={m}")
    dev, i32 = R.device, (torch.int32,)
    for name, t, dtypes, shape in (
            ("R", R, (torch.float32, torch.bfloat16), (n, m)),
            ("a", a, (R.dtype,), (B, n)),
            ("act_mask", act_mask, i32, (B, n // BL)),
            ("rmask", rmask, i32, (n // BL, m // BM)),
            ("block_count", block_count, (torch.int64,), (1,))):
        if t is not None:
            _build.check_operand("event_matmul", name, t, dtypes, shape, dev)
    y = torch.empty((B, m), dtype=R.dtype, device=dev)
    lib = _build.load("event_matmul")
    stream = torch.cuda.current_stream(dev).cuda_stream
    counter = None if block_count is None else block_count.data_ptr()
    with torch.cuda.device(dev):
        err = lib.repro_event_matmul(
            *(ctypes.c_void_p(t.data_ptr()) for t in (a, R, act_mask, rmask, y)),
            ctypes.c_void_p(counter), B, n, m, int(R.dtype == torch.bfloat16),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"event_matmul: kernel launch failed: "
                           f"{_build.error_string(lib, err)}")
    event_matmul.launches += 1
    return y


event_matmul.launches = 0
