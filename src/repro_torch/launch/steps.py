"""Step builders of the port: the LM train step and the serve steps.

Counterpart of `repro.launch.steps` (`batch_abstract`, `input_specs`,
`BuiltStep`, `default_optimizer`, `make_train_step`, `_prefill_callable`,
`make_prefill_step`, `make_decode_step`, `batch_shardings`,
`mirror_opt_shardings`).  There is no jit: a step is a Python function
over the parameter tree, and its abstract arguments are `meta` tensors
(`models.module.abstract`), which the dry-run (`launch/dryrun_lib.py`)
runs the step on.  A serve step is built for a device: on `meta` it takes
the plain versions of the kernels (no kernel wrapper takes a meta
tensor), on the card the kernels.  The sharding helpers return the
reference's shardings over a mesh (`models.module.NamedSharding`).

With `mesh=` a step is explicit SPMD over the caller's process group:
each rank runs it on its local shards (`models.module.ShardCtx`).  Its
parameters and optimizer state are placed by the `BuiltStep`'s
`shardings` (`sharding.place_tree`, and `init_opt_state`), its batch is
given whole and each rank takes its rows, and it returns its outputs
placed (DTensors, or plain tensors where a sharding replicates).  The
train step picks pure data parallelism as the reference does.  Every
family runs under a mesh; adafactor's factored moments do not (ROADMAP
item 17).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import sharding as SH
from repro_torch.configs.base import ModelConfig, ShapeSuite
from repro_torch.models import get_model
from repro_torch.models.module import (NamedSharding, ShardCtx, abstract,
                                       mesh_shape, tree_shardings)
from repro_torch.optim import clip_by_global_norm, make_optimizer, microbatch_grads
from repro_torch.tree import (tree_flatten_with_path, tree_leaves, tree_map,
                               tree_map_with_path)

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


def batch_shardings(cfg: ModelConfig, shape: ShapeSuite, mesh,
                    pure_dp: bool = False) -> dict:
    """A NamedSharding a batch leaf: the batch dim over the batch axes (and
    'model' with `pure_dp`), shedding trailing axes until they divide the
    global batch (a batch too small to split is replicated)."""
    ba = SH.batch_axes(mesh) + (("model",) if pure_dp else ())
    B = shape.global_batch

    def spec(x):
        axes = SH.split_dims(mesh, ba, B)
        rest = (None,) * (x.dim() - 1)
        return NamedSharding(mesh, (axes if axes else None,) + rest)
    return {k: spec(x) for k, x in batch_abstract(cfg, shape).items()}


def _size(mesh, axes) -> int:
    sizes = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def mirror_opt_shardings(opt_abs: dict, params_abs: Tree, params_sh: Tree,
                         mesh) -> dict:
    """Opt state sharded leaf for leaf like the params where the structure
    and shapes match (adamw/lion/sgdm moments); other state (adafactor's
    factored vr/vc, step counters) replicates."""
    p_leaves = tree_flatten_with_path(params_abs)
    sh_leaves = dict(tree_flatten_with_path(params_sh))
    rep = NamedSharding(mesh, ())

    def sub(sub_abs):
        leaves = tree_flatten_with_path(sub_abs)
        same = ([p for p, _ in leaves] == [p for p, _ in p_leaves]
                and all(tuple(a.shape) == tuple(b.shape)
                        for (_, a), (_, b) in zip(leaves, p_leaves)))
        if same:
            return tree_map_with_path(lambda path, _: sh_leaves[path],
                                      sub_abs)
        return tree_map_with_path(lambda path, _: rep, sub_abs)

    return {k: sub(v) for k, v in opt_abs.items()}


@dataclasses.dataclass
class BuiltStep:
    fn: Callable                 # the step, a Python function
    args_abstract: tuple         # its arguments' meta stand-ins
    donate: tuple = ()           # arguments the step updates in place
    shardings: dict | None = None   # with a mesh: the arguments' and outputs'


# ---------------------------------------------------------------------------
# Under a mesh
# ---------------------------------------------------------------------------

def pure_dp_for(cfg: ModelConfig, mesh, shape: ShapeSuite) -> bool:
    """The reference's choice: pure data parallelism where the config asks
    for it and the global batch divides over the batch axes and 'model'."""
    return (cfg.train_pure_dp and shape.global_batch
            % _size(mesh, SH.batch_axes(mesh) + ("model",)) == 0)


def _rows(x: torch.Tensor, mesh, dims: tuple) -> torch.Tensor:
    """This rank's rows of a whole batch leaf split over `dims`."""
    if not dims:
        return x
    n = x.shape[0] // _size(mesh, dims)
    return x[SH.group_index(mesh, dims) * n:][:n]


def init_opt_state(opt, params: Tree, opt_sh: Tree) -> Tree:
    """`opt.init` on each rank's local shards, placed by `opt_sh`."""
    return tree_map_with_path(
        lambda path, x: SH.from_local(x, _at(opt_sh, path)),
        opt.init(SH.local_tree(params)))


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


def make_train_step(cfg: ModelConfig, opt=None, shape: ShapeSuite = None, *,
                    mesh=None):
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    {"loss", "grad_norm"}): the loss and gradients over
    cfg.n_microbatches slices of the batch, the gradients clipped to
    global norm 1.0, then `opt`'s update (default: `default_optimizer`),
    written into the parameter and state tensors passed in
    (`update_in_place`), which are returned.  With a `shape`, a
    `BuiltStep` whose abstract arguments are the meta parameters,
    optimizer state and batch, and step 0 (the optimizers read the step
    as a Python int).  With a `mesh` (and a `shape`), the step over the
    mesh: see `_sharded_train_step`."""
    api = get_model(cfg)
    opt = opt or default_optimizer(cfg)
    if mesh is not None:
        return _sharded_train_step(cfg, api, opt, shape, mesh)

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


def _sharded_train_step(cfg, api, opt, shape, mesh) -> BuiltStep:
    """The train step on each rank's shards.  The loss is the whole
    batch's (each rank's rows, the sums and the count summed over the
    batch's split dims); each weight's gradient is summed over those dims
    by its FSDP gather's backward, or by one all_reduce a bucket after the
    backward; the norm is the whole tree's; the update runs leaf by leaf
    on the local shards.  So loss, grad_norm and parameters are the
    one-rank step's.  The batch leaves come whole; the params and state
    placed by `shardings` ("params", "opt"; "batch" says how the rows
    split)."""
    if shape is None:
        raise ValueError("a train step over a mesh needs the shape (its "
                         "global batch picks the layout)")
    if not opt.elementwise:
        raise NotImplementedError(
            "adafactor's factored moments over a mesh need each leaf's whole "
            "rows and columns: ROADMAP item 17")
    pure_dp = pure_dp_for(cfg, mesh, shape)
    rules = SH.make_rules(cfg, mesh, pure_dp=pure_dp)
    specs = api.specs(cfg)
    params_sh = tree_shardings(specs, rules, mesh)
    params_abs = abstract(specs)
    opt_sh = mirror_opt_shardings(opt.init(params_abs), params_abs, params_sh,
                                  mesh)
    b_sh = batch_shardings(cfg, shape, mesh, pure_dp=pure_dp)
    axes = SH.batch_axes(mesh) + (("model",) if pure_dp else ())
    sizes = mesh_shape(mesh)
    stored = tree_map(SH.placed_dims, params_sh)     # a tuple a leaf
    rep = tree_map(lambda s: math.prod(n for d, n in sizes.items()
                                       if d not in SH.placed_dims(s)),
                   params_sh)

    def train_step(params, opt_state, batch, step):
        lp, ls = SH.local_tree(params), SH.local_tree(opt_state)
        rows = next(iter(batch.values())).shape[0] // cfg.n_microbatches
        dims = SH.split_dims(mesh, axes, rows)
        ctx = ShardCtx(mesh, rules, batch=dims)

        def loss(p, mb):
            return api.loss_fn(cfg, p, {k: _rows(v, mesh, dims)
                                        for k, v in mb.items()}, ctx=ctx)

        lv, grads = microbatch_grads(loss, lp, batch, cfg.n_microbatches)
        gl, need = [], []
        tree_map(lambda g, st: (gl.append(g), need.append(
            tuple(d for d in dims if d not in st))), grads, stored)
        it = iter(SH.reduce_grads(gl, need, mesh))
        grads = tree_map(lambda _: next(it), grads)
        grads, gnorm = clip_by_global_norm(
            grads, 1.0, mesh=mesh, rep=tree_map(lambda _, r: r, grads, rep))
        update_in_place(opt, grads, ls, lp, step)
        return params, opt_state, {"loss": lv.float(), "grad_norm": gnorm}

    args = (params_abs, opt.init(params_abs), batch_abstract(cfg, shape), 0)
    return BuiltStep(train_step, args, donate=(0, 1),
                     shardings={"params": params_sh, "opt": opt_sh,
                                "batch": b_sh, "pure_dp": pure_dp})


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def _on_meta(device) -> bool:
    return torch.device(device).type == "meta"


def _prefill_callable(cfg: ModelConfig, api, max_seq: int, plain: bool,
                      ctx=None):
    """prefill(params, batch) -> (last-position logits, cache with room for
    max_seq positions); `plain` takes RWKV6's plain WKV (K4's wrapper
    refuses a meta tensor); `ctx` a mesh's."""
    kw = {} if ctx is None else {"ctx": ctx}
    if cfg.family == "decoder":
        def f(params, batch):
            return api.prefill(cfg, params, batch["tokens"],
                               batch.get("patch_embeds"), max_seq=max_seq,
                               **kw)
    elif cfg.family == "encdec":
        def f(params, batch):
            return api.prefill(cfg, params, batch["tokens"], batch["frames"],
                               max_seq=max_seq, **kw)
    elif cfg.family == "rwkv6":
        def f(params, batch):            # the state does not grow with S
            return api.prefill(cfg, params, batch["tokens"], plain=plain,
                               **kw)
    else:
        def f(params, batch):
            return api.prefill(cfg, params, batch["tokens"], max_seq=max_seq,
                               **kw)
    return f


def make_prefill_step(cfg: ModelConfig, shape: ShapeSuite,
                      device="meta", *, mesh=None) -> BuiltStep:
    """The prefill of the shape's batch on `cfg.replace(remat="none")`,
    its cache sized to the shape's S (a shorter prompt leaves room to
    decode up to S), built for `device`.  With a `mesh`, over the mesh on
    its device: fn(params, batch) -> (logits, cache) placed by
    `shardings` ("logits", "cache"; "params" places the parameters)."""
    icfg = cfg.replace(remat="none")
    api = get_model(icfg)
    args = (abstract(api.specs(icfg)), input_specs(icfg, shape))
    if mesh is None:
        fn = _prefill_callable(icfg, api, shape.seq_len, _on_meta(device))
        return BuiltStep(fn, args)
    sh, ctx, dims = SH.serve_layout(icfg, api, shape.global_batch,
                                    shape.seq_len, mesh)
    inner = _prefill_callable(icfg, api, shape.seq_len, False, ctx)

    def fn(params, batch):
        with torch.no_grad():
            logits, cache = inner(SH.local_tree(params),
                                  {k: _rows(v, mesh, dims)
                                   for k, v in batch.items()})
        return (SH.from_local(logits, sh["logits"]),
                tree_map(SH.from_local, cache, sh["cache"]))
    return BuiltStep(fn, args, shardings=sh)


def make_decode_step(cfg: ModelConfig, shape: ShapeSuite,
                     device="meta", *, mesh=None) -> BuiltStep:
    """One decode step of the shape's batch on `cfg.replace(remat="none")`
    from a cache sized to the shape's S: fn(params, token, cache, pos) ->
    (logits [B, V] f32, new cache; the old one is not written, so nothing
    is donated).  No kernel lies on a decode path, so `device` changes
    nothing here; it is taken for symmetry.  With a `mesh`: token and pos
    whole, the cache placed by `shardings["cache"]` (a prefill's over the
    same mesh and shape), the logits and new cache placed."""
    del device
    icfg = cfg.replace(remat="none")
    api = get_model(icfg)
    args = _decode_inputs(icfg, shape)      # whatever the shape's kind
    args = (abstract(api.specs(icfg)), args["token"], args["cache"],
            args["pos"])
    if mesh is None:
        def fn(params, token, cache, pos):
            return api.decode_step(icfg, params, token, cache, pos)
        return BuiltStep(fn, args)
    sh, ctx, dims = SH.serve_layout(icfg, api, shape.global_batch,
                                    shape.seq_len, mesh)

    def fn(params, token, cache, pos):
        with torch.no_grad():
            logits, new = api.decode_step(
                icfg, SH.local_tree(params), _rows(token, mesh, dims),
                SH.local_tree(cache), _rows(pos, mesh, dims), ctx=ctx)
        return (SH.from_local(logits, sh["logits"]),
                tree_map(SH.from_local, new, sh["cache"]))
    return BuiltStep(fn, args, shardings=sh)
