"""BPTT oracle, in PyTorch: the same cells and surrogate gradient,
differentiated by autograd through the unrolled sequence.

Counterpart of `repro.core.bptt`.  The exact RTRL engines must agree with
it on every surviving parameter (BPTT also gives pruned parameters a
gradient, which the masked optimizer discards).  The streaming BPTT
learner (`engine="bptt"`) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import cells
from repro_torch.core.cells import EGRUConfig
from repro_torch.tree import tree_leaves, tree_map


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def bptt_loss_and_grads(cfg: EGRUConfig, params, xs: torch.Tensor,
                        labels: torch.Tensor):
    """(loss, grads, stats) via reverse mode through the unrolled sequence.

    params is the single-layer tree; grads has its structure."""
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_leaves(params)]
    live = _unflatten_like(params, leaves)
    with torch.enable_grad():
        loss, stats = cells.sequence_loss(cfg, live, xs, labels)
        grads = torch.autograd.grad(loss, leaves)
    stats = {k: v.detach() for k, v in stats.items()}
    return loss.detach(), _unflatten_like(params, grads), stats
