"""Chunked RWKV6 WKV with the [D, D] state resident on chip: one kernel
launch per layer of a prefill.

Counterpart of `repro.kernels.wkv` (kernel K4).  For each (batch, head)
the f32 state S [D, D] carries across chunks of length L in order, and
chunk by chunk, with logP the per-channel cumulative sum of logw inside
the chunk and logP_{-1} = 0:

  o_i   = (r_i * e^{logP_{i-1}}) S + sum_{j<=i} A[i,j] v_j
  A[i,j] = sum_d r_id k_jd e^{min(logP_{i-1,d} - logP_{j,d}, 0)}   (j < i)
  A[i,i] = sum_d r_id u_d k_id
  S     <- diag(e^{logP_L}) S + (k * e^{logP_L - logP})^T v

(the clamped joint exponent of `models/rwkv.py::wkv_chunk`).  The TPU
kernel zeroes its state at chunk 0 and never writes it out; `wkv_full`
needs the state in and out for the serving cache, so here S starts from
an optional S0 and the final state is returned.  With S0 = 0 the output
is `wkv_pallas`'s function.

  * `wkv` — the wrapper.  On CUDA tensors it launches the hand-written
    kernel (`csrc/wkv.cu`, built at first use by `kernels._build`; one CTA
    per (b, h, 32 value columns) at D = 64, a head's two CTAs a cluster
    that shares the column-independent work, the state in registers) or
    raises; on CPU tensors it runs `wkv_reference`.  `wkv.launches` counts
    launches.
  * `wkv_reference` — the plain PyTorch version: `wkv_chunk` chained over
    the chunks.
  * `wkv_chunk` — one chunk of the chunked algebra (the reference's
    `models/rwkv.py::wkv_chunk`; `models.rwkv` re-exports it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_D = 64         # head width the kernel takes (RWKV6-3B: 64)
D_STEP = 16        # ... in multiples of the narrowest CTA's value columns
MAX_L = 64         # chunk length the kernel takes (RWKV6-3B: 16)


def wkv_chunk(r, k, v, logw, u, S_prev):
    """One chunk. r/k/v: [B,H,L,D]; logw: [B,H,L,D] (<=0, f32); u: [H,D];
    S_prev: [B,H,D,Dv].  Returns (o [B,H,L,D] f32, S_new)."""
    logP = torch.cumsum(logw, dim=2)                     # [B,H,L,D]
    logP_prev = logP - logw                              # logP_{i-1}
    rf, kf, vf = r.float(), k.float(), v.float()

    # inter-chunk: o_inter[i] = (r_i * exp(logP_{i-1})) @ S_prev
    q_inter = rf * torch.exp(logP_prev)
    o_inter = torch.einsum("bhld,bhdv->bhlv", q_inter, S_prev)

    # intra-chunk: A[i,j] = sum_d r_i k_j exp(logP_{i-1,d} - logP_{j,d}) (j<i)
    #              A[i,i] = sum_d r_i k_i u_d; the clamped exponent is <= 0.
    # `minimum` (not `clamp`): at j = i-1 the exponent is exactly 0, and
    # minimum's backward splits a tie's gradient in half, as jnp.minimum's
    # does, so the training gradients round as the reference's do
    delta = torch.minimum(logP_prev[:, :, :, None, :] - logP[:, :, None, :, :],
                          torch.zeros((), dtype=logP.dtype, device=logP.device))
    L = r.shape[2]
    ii = torch.arange(L, device=r.device)
    diag = (ii[:, None] == ii[None, :])[None, None, :, :, None]
    tri = (ii[:, None] > ii[None, :])[None, None, :, :, None]
    w_pair = torch.where(diag, u[None, :, None, None, :], torch.exp(delta))
    w_pair = torch.where(tri | diag, w_pair, 0.0)
    A = torch.einsum("bhid,bhijd,bhjd->bhij", rf, w_pair, kf)
    o_intra = torch.einsum("bhij,bhjv->bhiv", A, vf)

    # state: S_new = diag(exp(logP_L)) S_prev + sum_j (k_j e^{logP_L-logP_j}) v_j^T
    logP_L = logP[:, :, -1:, :]                          # [B,H,1,D]
    k_tail = kf * torch.exp(logP_L - logP)
    S_new = (torch.exp(logP_L[:, :, 0, :])[..., None] * S_prev
             + torch.einsum("bhld,bhlv->bhdv", k_tail, vf))
    return o_inter + o_intra, S_new


def _check_chunk(T: int, chunk: int) -> None:
    if chunk < 1 or T % chunk:
        raise ValueError(f"wkv: the sequence length T={T} must be a multiple "
                         f"of the chunk length L={chunk} (pad upstream)")


def wkv_reference(r, k, v, logw, u, S0=None, *, chunk: int = 16):
    """Plain PyTorch version: `wkv_chunk` chained over T / chunk chunks.
    Returns (o [B,H,T,D] f32, S_final [B,H,D,D] f32)."""
    B, H, T, D = r.shape
    _check_chunk(T, chunk)
    S = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if S0 is None else S0.float())
    outs = []
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        o, S = wkv_chunk(r[:, :, sl], k[:, :, sl], v[:, :, sl],
                         logw[:, :, sl], u, S)
        outs.append(o)
    return torch.cat(outs, dim=2), S


_CALLS: dict = {}
_DTYPES = (torch.float32, torch.bfloat16)


def _call(B, H, T, D, chunk, dtype, device, has_S0) -> _build.KernelCall:
    """The kernel's launch at these shapes, built once; `dtype` is r's (a
    kernel dtype, or the entries' check raises on r)."""
    key = (B, H, T, D, chunk, dtype, device, has_S0)
    call = _CALLS.get(key)
    if call is None:
        f32 = torch.float32
        entries = [("r", dtype, _DTYPES, (B, H, T, D)),
                   ("k", dtype, (dtype,), (B, H, T, D)),
                   ("v", dtype, (dtype,), (B, H, T, D)),
                   ("logw", f32, (f32,), (B, H, T, D)),
                   ("u", f32, (f32,), (H, D))]
        if has_S0:
            entries.append(("S0", f32, (f32,), (B, H, D, D)))
        lib = _build.load("wkv")
        call = _CALLS[key] = _build.KernelCall(
            "wkv", device, entries, lib, lib.repro_wkv,
            (B, H, T, D, chunk, int(dtype == torch.bfloat16)), n_ptrs=8)
    return call


def launch(call: _build.KernelCall, args) -> tuple:
    """Launch `call` on checked operands (r, k, v, logw, u[, S0]) into new
    outputs; returns (o, S_final).  Not counted: `wkv` counts its own."""
    r = args[0]
    B, H, T, D = r.shape
    ptrs = [t.data_ptr() for t in args]
    if (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) & 15:
        raise ValueError("wkv: r, k, v and logw must be 16-byte aligned")
    o = torch.empty((B, H, T, D), dtype=torch.float32, device=r.device)
    S = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    call.launch(*ptrs[:5], ptrs[5] if len(ptrs) > 5 else 0, o.data_ptr(),
                S.data_ptr())
    return o, S


def wkv(r, k, v, logw, u, S0=None, *, chunk: int = 16):
    """Chunked WKV over [B, H, T, D] (see the module docstring): r/k/v
    bf16 or f32 (one dtype), logw f32 (<= 0), u [H, D] f32, S0 an optional
    [B, H, D, D] f32 initial state (zeros when None).  T % chunk == 0.
    Returns (o [B,H,T,D] f32, S_final [B,H,D,D] f32).

    CPU tensors go to `wkv_reference`; CUDA tensors launch the kernel (one
    launch, counted in `wkv.launches`) or raise.  The kernel takes D a
    multiple of 16 up to 64, chunk <= 64, and r, k, v, logw 16-byte
    aligned (it copies 16 bytes at a time); a fresh tensor is.  It has no
    backward: an operand that requires grad under grad mode raises."""
    B, H, T, D = r.shape
    _check_chunk(T, chunk)
    if r.device.type == "cpu":
        return wkv_reference(r, k, v, logw, u, S0, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv: no kernel for device {r.device}")
    if D > MAX_D or D % D_STEP or chunk > MAX_L:
        raise ValueError(f"wkv: the kernel takes D <= {MAX_D}, a multiple of "
                         f"{D_STEP}, and chunk <= {MAX_L}, got D={D}, "
                         f"chunk={chunk}")
    args = (r, k, v, logw, u) + (() if S0 is None else (S0,))
    _build.refuse_autograd("wkv", *args)
    dtype = r.dtype if r.dtype in _DTYPES else torch.float32
    call = _call(B, H, T, D, chunk, dtype, r.device, S0 is not None)
    call.check(args)
    out = launch(call, args)
    wkv.launches += 1
    return out


wkv.launches = 0


def geometry(B: int, H: int, D: int, chunk: int, dtype, device) -> dict:
    """The kernel's launch at B*H heads of width D and this chunk: CTAs
    per (b, h) and a cluster, threads and dynamic shared bytes a CTA,
    registers and spilled bytes a thread, CTAs resident on an SM and
    clusters on the card (the card's own occupancy counts), input stages
    (2: the next chunk loads while one computes), and the grid."""
    lib = _build.load("wkv")
    out = (ctypes.c_longlong * 9)()
    with torch.cuda.device(device):
        err = lib.repro_wkv_geometry(D, chunk, int(dtype == torch.bfloat16),
                                     B * H, out)
    if err != 0:
        raise RuntimeError(f"wkv: {_build.error_string(lib, err)}")
    geo = dict(zip(("ctas_per_head", "cluster", "threads", "smem_bytes",
                    "registers", "spill_bytes", "ctas_per_sm",
                    "clusters_resident", "stages"), out))
    geo["grid"] = B * H * geo["ctas_per_head"]
    return geo
