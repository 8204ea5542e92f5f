"""Step builders of the port: the LM train step.

Counterpart of `repro.launch.steps` (`default_optimizer`,
`make_train_step`).  One device, so there is no mesh, no sharding and no
jit: the step is a Python function over the parameter tree.  The sharded
steps (item 13) and the prefill/decode step builders, which serve only the
dry-run (`launch/dryrun*.py`, item 14), are not ported.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.optim import clip_by_global_norm, make_optimizer, microbatch_grads
from repro_torch.tree import tree_flatten_with_path, tree_leaves

Tree = Any


def default_optimizer(cfg: ModelConfig):
    return make_optimizer(cfg.optimizer, lr=3e-4)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def update_in_place(opt, grads: Tree, state: dict, params: Tree, step) -> None:
    """`opt.update` applied leaf by leaf, each result copied into the old
    parameter and state buffers.  Every optimizer here updates a leaf from
    that leaf's gradient and state alone, so the values are bitwise the
    whole-tree update's; but the old and the new state coexist one leaf at
    a time, not whole (full-size training: rwkv6-3b's parameters, gradients
    and adamw moments are 37 GB, a second copy of the moments would not
    fit beside them on one 80 GB card)."""
    for path, p in tree_flatten_with_path(params):
        leaf_state = {k: _at(v, path) for k, v in state.items()}
        new_p, new_state = opt.update(_at(grads, path), leaf_state, p, step)
        p.copy_(new_p)
        for old, new in zip(tree_leaves(leaf_state), tree_leaves(new_state)):
            old.copy_(new)


def make_train_step(cfg: ModelConfig, opt=None) -> Callable:
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    {"loss", "grad_norm"}): the loss and gradients over
    cfg.n_microbatches slices of the batch, the gradients clipped to
    global norm 1.0, then `opt`'s update (default: `default_optimizer`),
    written into the parameter and state tensors passed in
    (`update_in_place`), which are returned."""
    api = get_model(cfg)
    opt = opt or default_optimizer(cfg)

    def loss(params, batch):
        return api.loss_fn(cfg, params, batch)

    def train_step(params, opt_state, batch, step):
        lv, grads = microbatch_grads(loss, params, batch, cfg.n_microbatches)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        update_in_place(opt, grads, opt_state, params, step)
        return params, opt_state, {"loss": lv.float(), "grad_norm": gnorm}

    return train_step
