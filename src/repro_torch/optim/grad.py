"""Gradient utilities: global-norm clipping, microbatch accumulation
(counterpart of `repro.optim.grad`)."""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.obs.metricpack import global_norm
from repro_torch.tree import tree_leaves, tree_map

Tree = Any


def clip_by_global_norm(tree: Tree, max_norm: float, *, mesh=None,
                        rep=None) -> tuple[Tree, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / norm) (in f32, back to its
    dtype); returns (clipped tree, norm).  The norm is the package's one
    clip norm (`obs.metricpack.global_norm`, the stream guard's); under a
    mesh that of the whole tree of local shards (`rep`: see there)."""
    norm = global_norm(tree, mesh=mesh, rep=rep)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def _value_and_grad(loss_fn: Callable, params: Tree, batch: Tree):
    leaves = tree_leaves(params)
    with torch.enable_grad():
        primal = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(primal, batch)
        grads = torch.autograd.grad(loss, tree_leaves(primal),
                                    allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def microbatch_grads(loss_fn: Callable, params: Tree, batch: Tree,
                     n_micro: int) -> tuple[torch.Tensor, Tree]:
    """(loss, grads) of loss_fn(params, batch).  With n_micro > 1 the batch
    is split into n_micro slices along axis 0 (each batch // n_micro rows;
    a batch that does not divide fails, as the reference's slices do) and
    the mean loss and gradients are accumulated in f32 with Kahan
    compensation: a plain f32 += drifts by ~n_micro ulps."""
    if n_micro <= 1:
        return _value_and_grad(loss_fn, params, batch)
    sizes = {x.shape[0] for x in tree_leaves(batch)}
    if len(sizes) != 1 or next(iter(sizes)) % n_micro:
        raise ValueError(f"microbatch_grads: batch axis {sorted(sizes)} does "
                         f"not split into {n_micro} microbatches")
    mb = next(iter(sizes)) // n_micro

    def kahan_add(acc, comp, x):
        y = x - comp
        t = acc + y
        return t, (t - acc) - y

    dev = tree_leaves(params)[0].device
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    loss_c = torch.zeros((), dtype=torch.float32, device=dev)
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    g_c = tree_map(torch.zeros_like, g_acc)
    for i in range(n_micro):
        mbatch = tree_map(lambda x: x[i * mb:(i + 1) * mb], batch)
        loss, grads = _value_and_grad(loss_fn, params, mbatch)
        loss_acc, loss_c = kahan_add(loss_acc, loss_c, loss)
        pairs = tree_map(lambda a, c, g: kahan_add(a, c, g.float()),
                         g_acc, g_c, grads)
        g_acc = tree_map(lambda _, pr: pr[0], g_acc, pairs)
        g_c = tree_map(lambda _, pr: pr[1], g_c, pairs)
    inv = 1.0 / n_micro
    return loss_acc * inv, tree_map(lambda g: g * inv, g_acc)
