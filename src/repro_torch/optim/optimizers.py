"""Optimizers as pure tree transforms on parameter dicts, in PyTorch.

Counterpart of `repro.optim.optimizers`: adamw, lion, adafactor and sgdm,
the fixed-mask wrapper and the dynamic one whose mask rewire events swap.
An :class:`Optimizer` is (init, update):

    state            = opt.init(params)
    params', state'  = opt.update(grads, state, params, step)

Updates return new tensors; nothing is modified in place.  ``step`` is the
integer update count, or, for a batch of slots updated under
`torch.func.vmap` (the stream fleet, adamw only), what
``opt.slot_steps(counts, device)`` makes of the slots' counts: each slot may
stand at another count.  ``lr`` may be a number or a schedule, host step ->
lr (`optim.schedules`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.tree import apply_mask_tree, tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree, int], tuple[Tree, Tree]]
    # ([S] host update counts, device) -> the step argument of a vmapped
    # update, one entry a slot along axis 0
    slot_steps: Callable[[Any, Any], Tree] = None
    # a leaf's update reads only that leaf's own elements (a mesh updates
    # each rank's shards alone); adafactor's factored moments read rows
    elementwise: bool = True
    # a non-elementwise optimizer's update on a mesh rank's local shards:
    # sharded_update(grads, state, params, step, splits, shapes, reduce),
    # see `adafactor`
    sharded_update: Callable | None = None

    def __post_init__(self):
        if self.slot_steps is None:
            object.__setattr__(self, "slot_steps", _no_slot_steps)


def _no_slot_steps(counts, device):
    raise NotImplementedError("per-slot update counts (the stream fleet) "
                              "are adamw's only")


def _sched(lr) -> Callable:
    """A schedule from `lr`: a callable is one, a number is constant."""
    return lr if callable(lr) else (lambda step: lr)


def _ipow1(base: float, step: int) -> np.float32:
    """``base ** (step + 1)`` in float32 for an integer update count, by
    binary exponentiation (31 multiply/selects), kept as the JAX package
    writes it so both round identically.  The count is a host integer, so
    the 31 rounds run on the host and cost no device launches."""
    e = int(step) + 1
    acc = np.float32(1.0)
    b = np.float32(base)
    for _ in range(31):
        if e & 1:
            acc = np.float32(acc * b)
        b = np.float32(b * b)
        e >>= 1
    return acc


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
          moment_dtype=torch.float32) -> Optimizer:
    """`step` is the host integer update count, or the pair (c1, c2) of
    bias corrections that `slot_steps` computes on the host for every
    slot's count (the same float32 rounding; `lr` a number then).  Either
    way the moments are divided by a float32 tensor, so that a slot's
    m / c1 is bitwise the unbatched update's on every device (CUDA would
    take a host scalar divisor as a product with its reciprocal).  The
    moments are stored in `moment_dtype` and updated in float32."""
    lr_fn = _sched(lr)

    def bias(step: int) -> tuple[float, float]:
        return (float(np.float32(1.0) - _ipow1(b1, step)),
                float(np.float32(1.0) - _ipow1(b2, step)))

    def slot_steps(counts, device):
        c = np.array([bias(int(s)) for s in counts], dtype=np.float32)
        c = torch.as_tensor(c.reshape(-1, 2), device=device)
        return c[:, 0], c[:, 1]

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=moment_dtype),
                              params),
                "v": tree_map(lambda p: torch.zeros_like(p, dtype=moment_dtype),
                              params)}

    def update(grads, state, params, step):
        if isinstance(step, tuple):
            c1, c2 = step
            lr_t = lr
        else:
            dev = tree_leaves(state["m"])[0].device
            c1, c2 = (torch.full((), c, dtype=torch.float32, device=dev)
                      for c in bias(step))
            lr_t = lr_fn(step)

        def leaf(g, m, v, p):
            g = g.float()
            m_new = b1 * m.float() + (1 - b1) * g
            v_new = b2 * v.float() + (1 - b2) * g.square()
            upd = (m_new / c1) / ((v_new / c2).sqrt() + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            p_new = p.float() - lr_t * upd
            return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

        out = tree_map(leaf, grads, state["m"], state["v"], params)
        return _pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2)}

    return Optimizer(init, update, slot_steps)


def lion(lr=1e-4, b1=0.9, b2=0.99, weight_decay=0.0,
         moment_dtype=torch.bfloat16) -> Optimizer:
    """Momentum only, in `moment_dtype` (bf16: 2 bytes a parameter); the
    update is sign(b1 m + (1 - b1) g)."""
    lr_fn = _sched(lr)

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=moment_dtype),
                              params)}

    def update(grads, state, params, step):
        lr_t = lr_fn(step)

        def leaf(g, m, p):
            g, mf = g.float(), m.float()
            upd = torch.sign(b1 * mf + (1 - b1) * g)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            p_new = p.float() - lr_t * upd
            return p_new.to(p.dtype), (b2 * mf + (1 - b2) * g).to(m.dtype)

        out = tree_map(leaf, grads, state["m"], params)
        return _pick(out, 0), {"m": _pick(out, 1)}

    return Optimizer(init, update)


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_threshold=1.0) -> Optimizer:
    """Factored second moment for a leaf of rank >= 2 (row and column
    means of g^2 + eps: O(n + m) state for [n, m]), a full one below; the
    update is clipped to RMS <= clip_threshold.  beta = 1 - t^-decay with
    t = step + 1, float32 on the host.

    Over a mesh (`sharded_update`) each rank updates its local shards,
    its moments the slices of the one-device moments (vr split like the
    leaf's leading dims, vc like its leading dims and last): every mean
    over a dim sums the ranks' partial sums over the mesh dims that split
    that dim, in three rounds whatever the number of leaves (the row and
    column sums of g^2; vr's; the update's sum of squares)."""
    lr_fn = _sched(lr)

    def init(params):
        def leaf(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if p.dim() >= 2:
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"f": tree_map(leaf, params)}

    def coefficients(step):
        t = np.float32(step) + np.float32(1.0)
        beta = np.float32(1.0) - t ** np.float32(-decay)
        return float(beta), float(np.float32(1.0) - beta), lr_fn(step)

    def scaled(g, s, b, nb, vr, vc, vr_mean):
        """The unclipped update of one leaf from its new moments."""
        if g.dim() >= 2:
            denom = (vr[..., None] * vc[..., None, :]
                     / vr_mean[..., None].clamp(min=eps))
            return g * torch.rsqrt(denom.clamp(min=eps)), {"vr": vr, "vc": vc}
        v = b * s["v"] + nb * (g.square() + eps)
        return g * torch.rsqrt(v.clamp(min=eps)), {"v": v}

    def finish(p, upd, rms, lr_t):
        upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
        return (p.float() - lr_t * upd).to(p.dtype)

    def update(grads, state, params, step):
        b, nb, lr_t = coefficients(step)

        def leaf(g, p, s):
            g = g.float()
            vr = vc = vr_mean = None
            if g.dim() >= 2:
                g2 = g.square() + eps
                vr = b * s["vr"] + nb * g2.mean(dim=-1)
                vc = b * s["vc"] + nb * g2.mean(dim=-2)
                vr_mean = vr.mean(dim=-1, keepdim=True)
            upd, new_s = scaled(g, s, b, nb, vr, vc, vr_mean)
            rms = torch.sqrt(upd.square().mean() + 1e-12)
            return finish(p, upd, rms, lr_t), new_s

        flat_g, flat_p = tree_leaves(grads), tree_leaves(params)
        flat_s = _state_leaves(state["f"], params)
        outs = iter([leaf(g, p, st) for g, p, st in zip(flat_g, flat_p, flat_s)])
        pairs = tree_map(lambda _: next(outs), params)
        return _pick(pairs, 0), {"f": _pick(pairs, 1)}

    def sharded_update(grads, state, params, step, splits, shapes, reduce):
        """`update` on a mesh rank's local shards.  splits: for each leaf
        (params' leaf order) a tuple, a tensor dim each, of the mesh dims
        that split that dim; shapes: each leaf's whole shape; reduce([(x,
        mesh dims)]) -> each x summed over its mesh dims (a dims tuple of
        () leaves x as it is).  The means divide by the whole dims."""
        b, nb, lr_t = coefficients(step)
        flat_g = [g.float() for g in tree_leaves(grads)]
        flat_p = tree_leaves(params)
        flat_s = _state_leaves(state["f"], params)
        over = lambda sp, dims: tuple(m for d in dims for m in sp[d])
        fact = [i for i, g in enumerate(flat_g) if g.dim() >= 2]
        # round 1: the row and column sums of g^2 + eps
        sums = reduce([item for i in fact for item in (
            ((flat_g[i].square() + eps).sum(dim=-1), over(splits[i], (-1,))),
            ((flat_g[i].square() + eps).sum(dim=-2), over(splits[i], (-2,))))])
        moments = {}
        for j, i in enumerate(fact):
            s, shape = flat_s[i], shapes[i]
            moments[i] = (b * s["vr"] + nb * sums[2 * j] / shape[-1],
                          b * s["vc"] + nb * sums[2 * j + 1] / shape[-2])
        # round 2: vr's sums over its last dim (the leaf's rows)
        vr_sums = reduce([(moments[i][0].sum(dim=-1, keepdim=True),
                           over(splits[i], (-2,))) for i in fact])
        vr_means = {i: x / shapes[i][-2] for i, x in zip(fact, vr_sums)}
        ups = [scaled(g, st, b, nb, *(moments[i] + (vr_means[i],)
                                      if i in moments else (None,) * 3))
               for i, (g, st) in enumerate(zip(flat_g, flat_s))]
        # round 3: each update's sum of squares over the whole leaf
        sq = reduce([(u.square().sum(), over(sp, range(len(sp))))
                     for (u, _), sp in zip(ups, splits)])
        outs = iter([
            (finish(p, u, torch.sqrt(q / math.prod(shape) + 1e-12), lr_t), st)
            for p, (u, st), q, shape in zip(flat_p, ups, sq, shapes)])
        pairs = tree_map(lambda _: next(outs), params)
        return _pick(pairs, 0), {"f": _pick(pairs, 1)}

    return Optimizer(init, update, elementwise=False,
                     sharded_update=sharded_update)


def _state_leaves(state, params) -> list:
    """The per-parameter state dicts of `state` (a tree shaped like params
    whose leaves are dicts), in params' leaf order."""
    if isinstance(params, dict):
        return [x for k in params for x in _state_leaves(state[k], params[k])]
    if isinstance(params, (list, tuple)):
        return [x for s, p in zip(state, params) for x in _state_leaves(s, p)]
    return [state]


def sgdm(lr=1e-2, momentum=0.9) -> Optimizer:
    lr_fn = _sched(lr)

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                              params)}

    def update(grads, state, params, step):
        lr_t = lr_fn(step)

        def leaf(g, m, p):
            m_new = momentum * m + g.float()
            return (p.float() - lr_t * m_new).to(p.dtype), m_new

        out = tree_map(leaf, grads, state["m"], params)
        return _pick(out, 0), {"m": _pick(out, 1)}

    return Optimizer(init, update)


def _pick(tree, i):
    """Component i of a tree whose leaves are tuples."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def masked(opt: Optimizer, mask: Tree) -> Optimizer:
    """Zero both gradients and updates where mask == 0 (pruned weights stay
    pruned and their optimizer state stays zero)."""
    def update(grads, state, params, step):
        p_new, s_new = opt.update(apply_mask_tree(mask, grads), state,
                                  params, step)
        return apply_mask_tree(mask, p_new), s_new

    return Optimizer(opt.init, update, opt.slot_steps, opt.elementwise)


def masked_dynamic(opt: Optimizer, mask0: Tree) -> Optimizer:
    """`masked`, but the mask lives in the optimizer STATE instead of a
    closure, so prune-and-regrow rewire events can swap it with
    `set_opt_mask`.  State: ``{"inner": <wrapped state>, "mask": mask
    tree}`` (the JAX package's layout, so checkpoints name its leaves
    `opt__mask__layers__0__u__W`, ...)."""
    def init(params):
        return {"inner": opt.init(params), "mask": mask0}

    def update(grads, state, params, step):
        mk = state["mask"]
        p_new, s_new = opt.update(apply_mask_tree(mk, grads),
                                  state["inner"], params, step)
        return apply_mask_tree(mk, p_new), {"inner": s_new, "mask": mk}

    return Optimizer(init, update, opt.slot_steps, opt.elementwise)


def set_opt_mask(state: Tree, new_mask: Tree) -> Tree:
    """Swap the mask of a `masked_dynamic` state after a rewire event and
    zero the moments ('m'/'v') outside the new mask: pruned weights lose
    their momentum, regrown weights start from zero moments, and pruned
    optimizer state stays zero."""
    if not (isinstance(state, dict) and "mask" in state):
        raise ValueError("set_opt_mask expects a masked_dynamic state "
                         "({'inner': ..., 'mask': ...})")
    inner = dict(state["inner"])
    for k in ("m", "v"):
        if k in inner:
            inner[k] = apply_mask_tree(new_mask, inner[k])
    return {"inner": inner, "mask": new_mask}


def make_optimizer(name: str, lr=None, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr if lr is not None else 1e-3, **kw)
    if name == "lion":
        return lion(lr if lr is not None else 1e-4, **kw)
    if name == "adafactor":
        return adafactor(lr if lr is not None else 1e-2, **kw)
    if name == "sgdm":
        return sgdm(lr if lr is not None else 1e-2, **kw)
    raise ValueError(name)
