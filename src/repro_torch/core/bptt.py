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


def window_bptt_loss_and_grads(cell, params, xs: torch.Tensor,
                               ys: torch.Tensor):
    """BPTT oracle of one online window with a label a step, for any zoo
    cell (`repro_torch.cells`): from the cell's initial state, s_t =
    cell.step_st(w, s_{t-1}, x_t) and loss = sum_t xent(cell.readout(
    params, s_t), y_t) / T, the learners' window loss at t_total = T.
    xs [T, B, n_in], ys [T, B].  (loss, grads) by reverse mode, grads in
    params' structure (the pruned parameters get a gradient too)."""

    def loss_fn(p):
        s = cell.init_state(xs.shape[1], device=xs.device)
        w, losses = cell.rec_params(p), []
        for x_t, y_t in zip(xs, ys):
            s = cell.step_st(w, s, x_t)
            losses.append(cells.xent(cell.readout(p, s), y_t))
        return torch.stack(losses).sum() / xs.shape[0], {}

    loss, grads, _ = _loss_and_grads(loss_fn, params)
    return loss, grads


def bptt_train_step(cfg: EGRUConfig, params, opt, opt_state, batch, step,
                    masks=None):
    xs, labels = batch
    loss, grads, stats = bptt_loss_and_grads(cfg, params, xs, labels)
    params, opt_state = opt.update(grads, opt_state, params, step)
    return params, opt_state, loss, stats
