"""Fused dual-compact influence update: gather + contract + Mbar + scale,
one kernel launch per step, ragged per example.

Counterpart of `repro.kernels.compact_fused`.  For example b and each live
new row r < count_new[b]:

    out[b, r, :] = hp_rows[b, r] * ( sum_{l < count_prev[b]}
                     J-hat[b, idx_new[b, r], idx_prev[b, l]] * vals[b, l, :]
                   + mbar_rows[b, r, :] )

and rows r >= count_new[b] are exactly 0.  Accumulation is f32; the carry
(vals, out) is f32 or bf16 and is cast once, on write.

  * `fused_update` — the wrapper the engine calls.  On a CUDA tensor it
    launches the hand-written kernel (`csrc/compact_fused.cu`, built at
    first use by `kernels._build`) through `_build.KernelCall`, or raises;
    on a CPU tensor it runs `fused_reference`.  The kernel has two
    branches, chosen by the capacity K and the carry's dtype alone
    (`tensor_cores`): an f32 carry at 256 < K <= 4096 takes the tensor
    cores (one CTA per (128 new rows, 128 columns, example), the product in
    3xTF32 wgmma with each chunk of 32 previous rows summed in registers of
    its own and added to the total in rounded f32); K <= 256, and a bf16
    carry at every K, keep the CUDA cores (one CTA per (16, 32 or 64 new
    rows, 128 columns, example), 8 rows x 4 columns a thread, 2 x 4 at
    K <= 16, previous rows through a cp.async ring).
    `fused_update.launches` counts kernel launches and
    `fused_update.tc_launches` those on the tensor cores.
  * `fused_reference` — the plain PyTorch version, with the JAX oracle's
    blockwise (bl=8) f32 accumulation and its zeroing of rows past
    count_new.
  * `geometry` — the kernel's launch shape (branch, grid, threads, shared
    bytes, registers, residency) at a capacity.

The JAX package's XLA lowering (`fused_update_blocks`, with its capacity
ladder) has no counterpart: the plain version and the kernel fill its role.
`capacity_ladder` and `fused_segments` are kept, built from host numpy as
there: the learner builds the segment table at init, which checks that
every gate's live columns are contiguous on the compact axis.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, compact as CK
from repro_torch.kernels._build import fold, is_transformed
from repro_torch.obs.trace import span

# gate-segment kinds on the compact column axis (see fused_segments)
_DIAG, _RGATE, _THETA = "diag", "r", "theta"


def _ceil8(v: int) -> int:
    return -(-int(v) // 8) * 8


def capacity_ladder(K: int) -> tuple[int, ...]:
    """Static capacity rungs: 8-aligned fractions of K (the JAX package's
    static-shape form of the kernel's per-example row skip)."""
    return tuple(sorted({_ceil8(K // 2), _ceil8(5 * K // 8),
                         _ceil8(3 * K // 4), _ceil8(7 * K // 8), int(K)}))


def fused_segments(layout, cl, layer: int = 0):
    """Static per-gate segment table of a ColLayout's compact column axis.

    Returns a tuple of (start, end, kind, coef_key, g_key, q[], j[]) with
    the column index arrays as host numpy int32.  kind: 'diag' (u/z, rnn v),
    'r' (the GRU r gate), 'theta' (the -I threshold block).  Raises if a
    gate's live columns are not contiguous."""
    from repro_torch.core import sparse_rtrl as SP     # imports this module
    gate, layr, live, q, j = (SP._np(t) for t in
                              (cl.gate, cl.layer, cl.live, cl.q, cl.j))
    segs = []
    if layout.kind == "rnn":
        table = [(0, _DIAG, "v_diag_coef", "v_g")]
    else:
        gid = {g: i for i, g in enumerate(layout.gates)}
        table = [(gid["u"], _DIAG, "u_diag_coef", "u_g"),
                 (gid["r"], _RGATE, "r_coef", "r_g"),
                 (gid["z"], _DIAG, "z_diag_coef", "z_g"),
                 (SP.COL_GATE_THETA, _THETA, None, None)]
    for g, kind, ck, gk in table:
        sel = np.nonzero((gate == g) & (layr == layer) & (live > 0))[0]
        if sel.size == 0:
            continue
        if not np.all(np.diff(sel) == 1):
            raise ValueError(f"gate {g} columns not contiguous in ColLayout")
        segs.append((int(sel[0]), int(sel[-1]) + 1, kind, ck, gk,
                     q[sel].astype(np.int32), j[sel].astype(np.int32)))
    segs.sort()
    return tuple(segs)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def fused_reference(Jhat, vals, mbar_rows, hp_rows, idx_new, idx_prev,
                    count_new, count_prev, *, bl: int = 8):
    """Plain PyTorch version of the fused update, with the JAX oracle's
    blockwise accumulation: previous rows in blocks of `bl`, ascending,
    each block's f32 product added only if the block starts below
    count_prev[b]; rows at or past count_new[b] zeroed.  (A trailing
    partial block, when K % bl != 0, is summed too.)"""
    B, K, Pc_pad = vals.shape
    Jgg = CK.gather_j_tiles(Jhat, idx_new, idx_prev)
    acc = torch.zeros((B, K, Pc_pad), dtype=torch.float32, device=vals.device)
    cp = count_prev.to(vals.device)
    for l0 in range(0, K, bl):
        blk = torch.bmm(Jgg[:, :, l0:l0 + bl].float(),
                        vals[:, l0:l0 + bl].float())
        live = (l0 < cp).float()[:, None, None]
        acc = acc + blk * live
    out = hp_rows[:, :, None] * (acc + mbar_rows.float())
    krow = torch.arange(K, device=vals.device)[None, :, None]
    keep = krow < count_new.clamp(max=K)[:, None, None]
    out = torch.where(keep, out, 0.0)
    return out.to(vals.dtype)


# ---------------------------------------------------------------------------
# The wrapper: the CUDA kernel on the card, the plain version on the CPU
# ---------------------------------------------------------------------------

_DTYPES = (torch.float32, torch.bfloat16)
# the capacities of the tensor-core branch, for an f32 carry (csrc/
# compact_fused.cu, tc::kMinK and tc::kMaxK)
TC_MIN_K, TC_MAX_K = 257, 4096
_CALLS: dict = {}
_last: list = [None]        # the last call's KernelCall, tried first


def _call(B, n, K, Pc, dtype, device) -> _build.KernelCall:
    """The kernel's launch at these shapes and carry dtype, built once;
    `dtype` is vals' (a kernel dtype, or the entries' check raises)."""
    key = (B, n, K, Pc, dtype, device)
    call = _CALLS.get(key)
    if call is None:
        f32, i32 = torch.float32, torch.int32
        entries = [("Jhat", f32, (f32,), (B, n, n)),
                   ("vals", dtype, _DTYPES, (B, K, Pc)),
                   ("mbar_rows", f32, (f32,), (B, K, Pc)),
                   ("hp_rows", f32, (f32,), (B, K)),
                   ("idx_new", i32, (i32,), (B, K)),
                   ("idx_prev", i32, (i32,), (B, K)),
                   ("count_new", i32, (i32,), (B,)),
                   ("count_prev", i32, (i32,), (B,))]
        lib = _build.load("compact_fused")
        call = _CALLS[key] = _build.KernelCall(
            "fused_update", device, entries, lib, lib.repro_fused_update,
            (B, n, K, Pc, int(dtype == torch.bfloat16)), n_ptrs=9)
        call.tensor_cores = tensor_cores(K, dtype)
    return call


def tensor_cores(K: int, dtype) -> bool:
    """Whether the kernel takes its tensor-core branch at capacity K for a
    carry of this dtype: an f32 carry at 256 < K <= 4096 (below, the CUDA
    cores were faster on the card at K 72, 128 and 256)."""
    return dtype == torch.float32 and TC_MIN_K <= K <= TC_MAX_K


def fused_update(Jhat, vals, mbar_rows, hp_rows, idx_new, idx_prev,
                 count_new, count_prev):
    """One fused dual-compact influence update.

    Jhat [B, n, n] f32 dense step Jacobian; vals [B, K, Pc] compact carry
    (f32 or bf16); mbar_rows [B, K, Pc] f32 M-bar at the new active rows
    (hp-ungated); hp_rows [B, K] f32 with dead slots zeroed; idx_new /
    idx_prev [B, K] int32 (-1 sentinel); count_new / count_prev [B] int32.
    Returns the new carry [B, K, Pc] in vals.dtype.

    CPU tensors go to `fused_reference`; CUDA tensors launch the kernel
    (one launch, counted in `fused_update.launches`) or raise.  The kernel
    takes Pc % 8 == 0 and vals and mbar_rows 16-byte aligned (it copies 16
    bytes at a time); the compact carry's Pc_pad and a fresh tensor are.
    The operands are checked in one comparison per tensor against the last
    call's shapes; only where that fails are the shapes looked at again.
    The kernel has no backward: an operand that requires grad under grad
    mode raises.

    Under `torch.func.vmap` (the stream fleet) the slots fold into the
    example axis (`kernels._build.fold`): one launch for every slot, counted
    once."""
    with span("k1.launch"):
        return _fused_update((Jhat, vals, mbar_rows, hp_rows, idx_new,
                              idx_prev, count_new, count_prev))


def _fused_update(args: tuple):
    Jhat, vals, mbar_rows, hp_rows = args[:4]
    call = _last[0]
    if call is None or not call.matches(args):
        if is_transformed(vals):
            return fold(fused_update, args)
        dev = vals.device
        if dev.type == "cpu":
            return fused_reference(*args)
        if dev.type != "cuda":
            raise ValueError(f"fused_update: no kernel for device {dev}")
        B, K, Pc = vals.shape
        if Pc % 8:
            raise ValueError(f"fused_update: the kernel takes Pc % 8 == 0 "
                             f"(16-byte rows of a bf16 carry), got Pc={Pc}")
        dtype = vals.dtype if vals.dtype in _DTYPES else torch.float32
        call = _call(B, Jhat.shape[-1], K, Pc, dtype, dev)
        call.check(args)
        _last[0] = call
    _build.refuse_autograd("fused_update", Jhat, vals, mbar_rows, hp_rows)
    try:
        ptrs = list(map(torch.Tensor.data_ptr, args))
    except RuntimeError:
        # a vmapped slot has no storage, and its shapes can match the last
        # call's: only here, off the unbatched call's path, is it folded
        if is_transformed(vals):
            return fold(fused_update, args)
        raise
    if (ptrs[1] | ptrs[2]) & 15:
        raise ValueError("fused_update: vals and mbar_rows must be 16-byte "
                         "aligned")
    out = torch.empty_like(vals)
    call.launch(*ptrs, out.data_ptr())
    fused_update.launches += 1
    fused_update.tc_launches += call.tensor_cores
    return out


fused_update.launches = 0
fused_update.tc_launches = 0


def geometry(B: int, K: int, Pc: int, dtype, device) -> dict:
    """The kernel's launch for B examples of capacity K and Pc columns:
    warps, threads, rows and columns a CTA, dynamic shared bytes a CTA,
    registers and spilled bytes a thread, CTAs resident on an SM (the card's
    own occupancy count), ring stages, the branch (`tensor_cores`) and the
    grid."""
    lib = _build.load("compact_fused")
    out = (ctypes.c_longlong * 10)()
    with torch.cuda.device(device):
        err = lib.repro_fused_geometry(K, int(dtype == torch.bfloat16), out)
    if err != 0:
        raise RuntimeError(f"fused_update: {_build.error_string(lib, err)}")
    geo = dict(zip(("warps", "threads", "rows", "smem_bytes", "registers",
                    "spill_bytes", "ctas_per_sm", "stages", "tensor_cores",
                    "cols"), out))
    geo["tensor_cores"] = bool(geo["tensor_cores"])
    geo["grid"] = B * -(-K // geo["rows"]) * -(-Pc // geo["cols"])
    return geo
