"""Plain-torch oracles of the influence update and gradient extraction.

Counterpart of `repro.kernels.ref` (the slice's part: the event matmul and
WKV oracles come with kernels K3 and K4)."""
from __future__ import annotations

import torch


def influence_ref(hp, Jhat, M, Mbar):
    """out[b] = D(hp[b]) (Jhat[b] @ M[b] + Mbar[b]).  All f32 math."""
    T = torch.bmm(Jhat.float(), M.float())
    return (hp.float()[:, :, None] * (T + Mbar.float())).to(M.dtype)


def influence_grads_ref(cbar, M):
    """Flat gradient extraction  dL/dw = c-bar^T M.  [B,n] x [B,n,P] -> [P]."""
    return torch.einsum("bk,bkp->p", cbar.float(), M.float())
