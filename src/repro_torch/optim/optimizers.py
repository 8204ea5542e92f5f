"""Optimizers as pure tree transforms on parameter dicts, in PyTorch.

Counterpart of `repro.optim.optimizers` (adamw, the fixed-mask wrapper
and the dynamic one whose mask rewire events swap; lion, adafactor and sgdm
are ROADMAP Queue 1 item 14).  An :class:`Optimizer` is (init, update):

    state            = opt.init(params)
    params', state'  = opt.update(grads, state, params, step)

Updates return new tensors; nothing is modified in place.  ``step`` is the
integer update count, or, for a batch of slots updated under
`torch.func.vmap` (the stream fleet), what ``opt.slot_steps(counts,
device)`` makes of the slots' counts: each slot may stand at another count.
"""
from __future__ import annotations

import dataclasses
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
    slot_steps: Callable[[Any, Any], Tree]


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


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0) -> Optimizer:
    """`step` is the host integer update count, or the pair (c1, c2) of
    bias corrections that `slot_steps` computes on the host for every
    slot's count (the same float32 rounding).  Either way the moments are
    divided by a float32 tensor, so that a slot's m / c1 is bitwise the
    unbatched update's on every device (CUDA would take a host scalar
    divisor as a product with its reciprocal)."""
    def bias(step: int) -> tuple[float, float]:
        return (float(np.float32(1.0) - _ipow1(b1, step)),
                float(np.float32(1.0) - _ipow1(b2, step)))

    def slot_steps(counts, device):
        c = np.array([bias(int(s)) for s in counts], dtype=np.float32)
        c = torch.as_tensor(c.reshape(-1, 2), device=device)
        return c[:, 0], c[:, 1]

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                              params),
                "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                              params)}

    def update(grads, state, params, step):
        if isinstance(step, tuple):
            c1, c2 = step
        else:
            dev = tree_leaves(state["m"])[0].device
            c1, c2 = (torch.full((), c, dtype=torch.float32, device=dev)
                      for c in bias(step))

        def leaf(g, m, v, p):
            g = g.float()
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g.square()
            upd = (m_new / c1) / ((v_new / c2).sqrt() + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            p_new = p.float() - lr * upd
            return p_new.to(p.dtype), m_new, v_new

        out = tree_map(leaf, grads, state["m"], state["v"], params)
        return _pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2)}

    return Optimizer(init, update, slot_steps)


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

    return Optimizer(opt.init, update, opt.slot_steps)


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

    return Optimizer(init, update, opt.slot_steps)


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
    raise NotImplementedError(
        f"optimizer {name!r} is not ported yet (ROADMAP Queue 1 item 14); "
        "the port has 'adamw'")
