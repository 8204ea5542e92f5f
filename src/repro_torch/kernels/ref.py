"""Plain-torch oracles of the kernels (the allclose references).

Counterpart of `repro.kernels.ref` (the slice's part: the flash-attention
oracle comes with the decoder family)."""
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
