"""BPTT oracle, in PyTorch: the same cells and surrogate gradient,
differentiated by autograd through the unrolled sequence.

Counterpart of `repro.core.bptt`.  The exact RTRL engines must agree with
it on every surviving parameter (BPTT also gives pruned parameters a
gradient, which the masked optimizer discards).  Behind the streaming
learner API this oracle is `core.learner.BPTTLearner` (`engine="bptt"`).
"""
from __future__ import annotations

import torch

from repro_torch.core import cells
from repro_torch.core.cells import EGRUConfig
from repro_torch.tree import tree_leaves, tree_map


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _loss_and_grads(loss_fn, params):
    """(loss, grads, stats) of loss_fn(params) -> (loss, stats) by reverse
    mode; grads has the structure of params."""
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_leaves(params)]
    live = _unflatten_like(params, leaves)
    with torch.enable_grad():
        loss, stats = loss_fn(live)
        grads = torch.autograd.grad(loss, leaves)
    stats = {k: v.detach() for k, v in stats.items()}
    return loss.detach(), _unflatten_like(params, grads), stats


def bptt_loss_and_grads(cfg: EGRUConfig, params, xs: torch.Tensor,
                        labels: torch.Tensor):
    """(loss, grads, stats) via reverse mode through the unrolled sequence.

    params is the single-layer tree; grads has its structure."""
    return _loss_and_grads(
        lambda p: cells.sequence_loss(cfg, p, xs, labels), params)


def stacked_bptt_loss_and_grads(cfg, params, xs: torch.Tensor,
                                labels: torch.Tensor):
    """Stacked BPTT oracle (cfg: cells.StackedEGRUConfig): reverse mode
    through the unrolled L-layer stack — the exactness reference for
    `core.stacked_rtrl`.  grads: {"layers": [...], "out": ...}."""
    return _loss_and_grads(
        lambda p: cells.stacked_sequence_loss(cfg, p, xs, labels), params)


def bptt_train_step(cfg: EGRUConfig, params, opt, opt_state, batch, step,
                    masks=None):
    xs, labels = batch
    loss, grads, stats = bptt_loss_and_grads(cfg, params, xs, labels)
    params, opt_state = opt.update(grads, opt_state, params, step)
    return params, opt_state, loss, stats
