"""Step builders of the port: the LM train step and the serve steps.

Counterpart of `repro.launch.steps` (`batch_abstract`, `input_specs`,
`BuiltStep`, `default_optimizer`, `make_train_step`, `_prefill_callable`,
`make_prefill_step`, `make_decode_step`).  One device, so there is no mesh,
no sharding and no jit: a step is a Python function over the parameter
tree, and its abstract arguments are `meta` tensors (`models.module.
abstract`), which the dry-run (`launch/dryrun_lib.py`) runs the step on.
A serve step is built for a device: on `meta` it takes the plain versions
of the kernels (no kernel wrapper takes a meta tensor), on the card the
kernels.  The sharding helpers (`batch_shardings`,
`mirror_opt_shardings`) wait for ROADMAP item 13.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeSuite
from repro_torch.models import get_model
from repro_torch.models.module import abstract
from repro_torch.optim import clip_by_global_norm, make_optimizer, microbatch_grads
from repro_torch.tree import tree_flatten_with_path, tree_leaves

Tree = Any


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def batch_abstract(cfg: ModelConfig, shape: ShapeSuite,
                   device="meta") -> dict:
    """Uninitialised batch tensors of the shape's size on `device` (meta:
    nothing allocated): tokens and labels [B, S] int32, and by family the
    VLM's patch embeddings [B, n_patches, 4096] or the encoder's frames
    [B, enc_seq, d] (bf16)."""
    B, S = shape.global_batch, shape.seq_len
    empty = lambda *size, dtype: torch.empty(size, dtype=dtype, device=device)
    batch = {"tokens": empty(B, S, dtype=torch.int32),
             "labels": empty(B, S, dtype=torch.int32)}
    if cfg.n_patches > 0:
        batch["patch_embeds"] = empty(B, cfg.n_patches, 4096,
                                      dtype=torch.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = empty(B, cfg.enc_seq, cfg.d_model,
                                dtype=torch.bfloat16)
    return batch


def input_specs(cfg: ModelConfig, shape: ShapeSuite) -> dict:
    """Meta stand-ins for every model input of the shape's step: the batch
    (train), the batch less its labels (prefill), or {token [B, 1], pos
    [B], cache} with the cache sized to the shape's S (decode).  One
    device: no shardings."""
    if shape.kind == "train":
        return batch_abstract(cfg, shape)
    if shape.kind == "prefill":
        b = batch_abstract(cfg, shape)
        b.pop("labels")
        return b
    return _decode_inputs(cfg, shape)


def _decode_inputs(cfg: ModelConfig, shape: ShapeSuite) -> dict:
    B, S = shape.global_batch, shape.seq_len
    return {"token": torch.empty((B, 1), dtype=torch.int32, device="meta"),
            "pos": torch.empty((B,), dtype=torch.int32, device="meta"),
            "cache": get_model(cfg).init_cache(cfg, B, S, "meta")}


@dataclasses.dataclass
class BuiltStep:
    fn: Callable                 # the step, a Python function
    args_abstract: tuple         # its arguments' meta stand-ins
    donate: tuple = ()           # arguments the step updates in place


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

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


def make_train_step(cfg: ModelConfig, opt=None, shape: ShapeSuite = None):
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    {"loss", "grad_norm"}): the loss and gradients over
    cfg.n_microbatches slices of the batch, the gradients clipped to
    global norm 1.0, then `opt`'s update (default: `default_optimizer`),
    written into the parameter and state tensors passed in
    (`update_in_place`), which are returned.  With a `shape`, a
    `BuiltStep` whose abstract arguments are the meta parameters,
    optimizer state and batch, and step 0 (the optimizers read the step
    as a Python int)."""
    api = get_model(cfg)
    opt = opt or default_optimizer(cfg)

    def loss(params, batch):
        return api.loss_fn(cfg, params, batch)

    def train_step(params, opt_state, batch, step):
        lv, grads = microbatch_grads(loss, params, batch, cfg.n_microbatches)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        update_in_place(opt, grads, opt_state, params, step)
        return params, opt_state, {"loss": lv.float(), "grad_norm": gnorm}

    if shape is None:
        return train_step
    params_abs = abstract(api.specs(cfg))
    args = (params_abs, opt.init(params_abs), batch_abstract(cfg, shape), 0)
    return BuiltStep(train_step, args, donate=(0, 1))


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def _on_meta(device) -> bool:
    return torch.device(device).type == "meta"


def _prefill_callable(cfg: ModelConfig, api, max_seq: int, plain: bool):
    """prefill(params, batch) -> (last-position logits, cache with room for
    max_seq positions); `plain` takes RWKV6's plain WKV (K4's wrapper
    refuses a meta tensor)."""
    if cfg.family == "decoder":
        def f(params, batch):
            return api.prefill(cfg, params, batch["tokens"],
                               batch.get("patch_embeds"), max_seq=max_seq)
    elif cfg.family == "encdec":
        def f(params, batch):
            return api.prefill(cfg, params, batch["tokens"], batch["frames"],
                               max_seq=max_seq)
    elif cfg.family == "rwkv6":
        def f(params, batch):            # the state does not grow with S
            return api.prefill(cfg, params, batch["tokens"], plain=plain)
    else:
        def f(params, batch):
            return api.prefill(cfg, params, batch["tokens"], max_seq=max_seq)
    return f


def make_prefill_step(cfg: ModelConfig, shape: ShapeSuite,
                      device="meta") -> BuiltStep:
    """The prefill of the shape's batch on `cfg.replace(remat="none")`,
    its cache sized to the shape's S (a shorter prompt leaves room to
    decode up to S), built for `device`."""
    icfg = cfg.replace(remat="none")
    api = get_model(icfg)
    fn = _prefill_callable(icfg, api, shape.seq_len, _on_meta(device))
    return BuiltStep(fn, (abstract(api.specs(icfg)),
                          input_specs(icfg, shape)))


def make_decode_step(cfg: ModelConfig, shape: ShapeSuite,
                     device="meta") -> BuiltStep:
    """One decode step of the shape's batch on `cfg.replace(remat="none")`
    from a cache sized to the shape's S: fn(params, token, cache, pos) ->
    (logits [B, V] f32, new cache; the old one is not written, so nothing
    is donated).  No kernel lies on a decode path, so `device` changes
    nothing here; it is taken for symmetry."""
    del device
    icfg = cfg.replace(remat="none")
    api = get_model(icfg)

    def fn(params, token, cache, pos):
        return api.decode_step(icfg, params, token, cache, pos)

    args = _decode_inputs(icfg, shape)      # whatever the shape's kind
    return BuiltStep(fn, (abstract(api.specs(icfg)), args["token"],
                          args["cache"], args["pos"]))
