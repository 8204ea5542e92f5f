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
    kernel (`csrc/wkv.cu`, built at first use by `kernels._build`) or
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
    #              A[i,i] = sum_d r_i k_i u_d; the clamped exponent is <= 0
    delta = (logP_prev[:, :, :, None, :] - logP[:, :, None, :, :]).clamp(max=0.0)
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


def wkv(r, k, v, logw, u, S0=None, *, chunk: int = 16):
    """Chunked WKV over [B, H, T, D] (see the module docstring): r/k/v
    bf16 or f32 (one dtype), logw f32 (<= 0), u [H, D] f32, S0 an optional
    [B, H, D, D] f32 initial state (zeros when None).  T % chunk == 0.
    Returns (o [B,H,T,D] f32, S_final [B,H,D,D] f32).

    CPU tensors go to `wkv_reference`; CUDA tensors launch the kernel (one
    launch, counted in `wkv.launches`) or raise."""
    B, H, T, D = r.shape
    _check_chunk(T, chunk)
    if r.device.type == "cpu":
        return wkv_reference(r, k, v, logw, u, S0, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv: no kernel for device {r.device}")
    if D > MAX_D or chunk > MAX_L:
        raise ValueError(f"wkv: the kernel takes D <= {MAX_D} and chunk <= "
                         f"{MAX_L}, got D={D}, chunk={chunk}")
    dev, f32 = r.device, torch.float32
    for name, t, dtypes, shape in (
            ("r", r, (torch.bfloat16, f32), (B, H, T, D)),
            ("k", k, (r.dtype,), (B, H, T, D)),
            ("v", v, (r.dtype,), (B, H, T, D)),
            ("logw", logw, (f32,), (B, H, T, D)),
            ("u", u, (f32,), (H, D)),
            ("S0", S0, (f32,), (B, H, D, D))):
        if t is not None:
            _build.check_operand("wkv", name, t, dtypes, shape, dev)
    o = torch.empty((B, H, T, D), dtype=f32, device=dev)
    S = torch.empty((B, H, D, D), dtype=f32, device=dev)
    lib = _build.load("wkv")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        err = lib.repro_wkv(ptr(r), ptr(k), ptr(v), ptr(logw), ptr(u),
                            ptr(S0), ptr(o), ptr(S), B, H, T, D, chunk,
                            int(r.dtype == torch.bfloat16),
                            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"wkv: kernel launch failed: "
                           f"{_build.error_string(lib, err)}")
    wkv.launches += 1
    return o, S


wkv.launches = 0
