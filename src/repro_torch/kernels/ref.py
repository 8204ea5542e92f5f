"""Plain-torch oracles of the kernels (the allclose references).

Counterpart of `repro.kernels.ref`."""
from __future__ import annotations

import torch


def influence_ref(hp, Jhat, M, Mbar):
    """out[b] = D(hp[b]) (Jhat[b] @ M[b] + Mbar[b]).  All f32 math."""
    T = torch.bmm(Jhat.float(), M.float())
    return (hp.float()[:, :, None] * (T + Mbar.float())).to(M.dtype)


def influence_grads_ref(cbar, M):
    """Flat gradient extraction  dL/dw = c-bar^T M.  [B,n] x [B,n,P] -> [P]."""
    return torch.einsum("bk,bkp->p", cbar.float(), M.float())


def event_matmul_ref(a, R):
    """y[b] = a[b] @ R with a activity-sparse.  [B,n] x [n,m] -> [B,m]."""
    return torch.einsum("bn,nm->bm", a.float(), R.float()).to(R.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None, cap=0.0):
    """Naive full-softmax attention. q:[B,S,H,D], k/v:[B,S,KV,D].  All f32
    math; the output in q's dtype.  `cap` > 0 applies the logit softcap
    cap * tanh(s / cap) to the scaled scores (the reference's oracle has
    no softcap; with cap = 0 the two are the same function)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale or D ** -0.5
    qg = q.reshape(B, S, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if cap > 0.0:
        s = cap * torch.tanh(s / cap)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window > 0:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = torch.where(mask[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return o.reshape(B, KV * G, S, D).transpose(1, 2).to(q.dtype)


def wkv_chunk_ref(r, k, v, logw, u, S_prev):
    """Sequential per-step WKV over one chunk (the exact recurrence).

    r/k/v/logw: [B,H,L,D]; u: [H,D]; S_prev: [B,H,D,Dv]."""
    S = S_prev.float()
    outs = []
    for t in range(r.shape[2]):
        rt, kt, vt = (x[:, :, t].float() for x in (r, k, v))
        kv = kt[..., None] * vt[:, :, None, :]
        outs.append(torch.einsum("bhd,bhdv->bhv", rt, S + u[None, ..., None] * kv))
        S = torch.exp(logw[:, :, t])[..., None] * S + kv
    return torch.stack(outs, dim=2), S       # [B,H,L,Dv], [B,H,D,Dv]
