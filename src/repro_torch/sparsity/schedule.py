"""Prune-and-regrow mask evolution: schedule + criteria (SET / RigL), in
PyTorch.

Counterpart of `repro.sparsity.schedule`.  Dynamic sparse training (SET:
Mocanu et al. 2018; RigL: Evci et al. 2020) periodically prunes the
smallest-magnitude live weights of each tensor and regrows the same number
of dead ones — at random (SET) or by dense-gradient magnitude (RigL).  It
composes with EXACT RTRL: a grown weight starts at 0 with zero influence,
pruned columns are dropped at update boundaries (where the gradient
accumulator was just consumed), and prune count == grow count per tensor,
so the live-column count Pc and every carry shape never change
(`repro_torch.sparsity.migrate`).

The selection is the reference's, in numpy: float64 magnitudes, stable
argsorts (ties broken by unit index), fine (block=1) or block-granular
(whole [block x block] tiles scored by their summed magnitude).  So on the
same scores the port's masks equal the JAX package's bit for bit.

Randomness (SET only): `jax.random` cannot be reproduced in torch, so the
port draws its SET scores from a `torch.Generator` seeded from the event
key — a tuple of ints (run seed, salt, event index, then layer, gate and
tensor folded in; `RewireSchedule.event_key`, `fold_in`), never from a
generator's running state: a restarted run draws the identical masks.
`rewire_tensor`/`rewire_masks`/`rewire_stacked_masks` also take the scores
as arrays, which the parity tests use to hand both packages the same draw.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

Tree = Any

_EVENT_SALT = 0x5e7  # separates the rewire key stream from training RNG


def fold_in(key: tuple, data: int) -> tuple:
    """The port's key folding: a key is a tuple of ints, and folding
    appends one."""
    return tuple(key) + (int(data),)


def key_generator(key: tuple) -> torch.Generator:
    """A CPU torch.Generator seeded from the whole key (a hash of its ints
    by numpy's SeedSequence), independent of any running RNG state."""
    words = [int(k) & 0xFFFFFFFF for k in key]
    seed = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed)


@dataclasses.dataclass(frozen=True)
class RewireSchedule:
    """When and how much to rewire (the reference's fields).

    method    'rigl' (gradient-magnitude regrowth) | 'set' (random regrowth)
    every_k   fire every K optimizer updates (at update boundaries only)
    frac      initial rewired fraction of each tensor's LIVE weights
    t_end     cosine-decay horizon in EVENTS (None: constant frac)
    block     mask granularity (1 = unstructured; >1 = whole tiles)
    """
    method: str = "rigl"
    every_k: int = 100
    frac: float = 0.3
    t_end: int | None = None
    block: int = 1

    def __post_init__(self):
        if self.method not in ("rigl", "set"):
            raise ValueError(f"method must be 'rigl' or 'set', "
                             f"got {self.method!r}")
        if self.every_k < 1:
            raise ValueError("every_k must be >= 1")

    def fires(self, update: int) -> bool:
        """Does a rewire event fire after optimizer update `update`?"""
        return update > 0 and update % self.every_k == 0

    def fraction(self, event: int) -> float:
        """Rewire fraction at event index `event` (cosine-decayed)."""
        if self.t_end is None or self.t_end <= 0:
            return self.frac
        e = min(event, self.t_end)
        return 0.5 * self.frac * (1.0 + math.cos(math.pi * e / self.t_end))

    @staticmethod
    def event_key(seed: int, event: int) -> tuple:
        """Deterministic per-event key (seed, salt, event index): no
        wall-clock or global state, so restarts replay the identical
        mask sequence."""
        return (int(seed), _EVENT_SALT, int(event))


# ---------------------------------------------------------------------------
# Per-tensor prune-and-regrow (count-preserving by construction)
# ---------------------------------------------------------------------------

def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _coarse(x: np.ndarray, block: int) -> np.ndarray:
    """Sum |x| over [block x block] tiles -> the tile score grid."""
    r, c = x.shape
    return np.abs(x).reshape(r // block, block, c // block, block).sum((1, 3))


def _expand(coarse: np.ndarray, shape: tuple, block: int) -> np.ndarray:
    """Replicate a coarse grid back to the fine mask (the indexing rule of
    `make_masks`' block construction)."""
    return coarse[np.arange(shape[0]) // block][:, np.arange(shape[1]) // block]


def rewire_tensor(mask, param, grad, *, frac: float, key: tuple | None = None,
                  method: str = "rigl", block: int = 1,
                  scores=None) -> torch.Tensor:
    """One tensor's prune-and-regrow event.  Returns the new float32 mask on
    the mask's device.

    Prunes the k smallest-|param| live units and grows k dead units — by
    largest |grad| (rigl) or by the largest SET scores (set: `scores` of
    the coarse mask's shape if given, else uniforms drawn from
    `key_generator(key)`) — with k = min(round(frac * live), dead): the
    live count never changes.  Deterministic: stable sorts, ties broken by
    unit index."""
    device = mask.device if isinstance(mask, torch.Tensor) else "cpu"
    m = _np64(mask) > 0
    p = _np64(param)
    if block > 1:
        if any(s % block for s in m.shape):
            raise ValueError(
                f"block={block} rewire needs tensor dims divisible by the "
                f"block (got {m.shape}); draw the mask at a dividing block")
        mc = m[::block, ::block]
        if not np.array_equal(m, _expand(mc, m.shape, block)):
            # a corner-sampled coarse grid would silently rewrite the mask
            # block-constant and change the fine live count
            raise ValueError(
                f"block={block} rewire needs a block-constant mask (draw it "
                f"with make_masks(block={block}), or rewire with block=1)")
        sp = _coarse(p, block)
    else:
        mc, sp = m, np.abs(p)
    live = mc.reshape(-1)
    n_live, n_dead = int(live.sum()), int((~live).sum())
    k = min(int(round(frac * n_live)), n_dead, n_live)
    if k <= 0:
        return torch.from_numpy(m.astype(np.float32)).to(device)
    # prune: k smallest-magnitude live units (dead -> +inf, never picked)
    prune_score = np.where(live, sp.reshape(-1), np.inf)
    pruned = np.argsort(prune_score, kind="stable")[:k]
    # grow: k best dead units (live -> -inf, never picked)
    if method == "rigl":
        if grad is None:
            raise ValueError("method='rigl' needs a dense gradient to score "
                             "regrowth; pass grad or use method='set'")
        gs = _coarse(_np64(grad), block) if block > 1 else np.abs(_np64(grad))
    elif method == "set":
        if scores is None:
            if key is None:
                raise ValueError("method='set' needs a key or scores")
            scores = torch.rand(mc.shape, generator=key_generator(key))
        gs = _np64(scores)
    else:
        raise ValueError(f"unknown rewire method {method!r}")
    grow_score = np.where(live, -np.inf, gs.reshape(-1))
    grown = np.argsort(-grow_score, kind="stable")[:k]
    new = live.copy()
    new[pruned] = False
    new[grown] = True
    if int(new.sum()) != n_live:              # count-preserving, always
        raise AssertionError(f"rewire changed the live count {n_live} -> "
                             f"{int(new.sum())}")
    newc = new.reshape(mc.shape)
    fine = _expand(newc, m.shape, block) if block > 1 else newc
    return torch.from_numpy(fine.astype(np.float32)).to(device)


def rewire_masks(masks: Tree, w: Tree, grads: Tree | None = None, *,
                 frac: float, key: tuple | None = None, method: str = "rigl",
                 block: int = 1, scores: Tree | None = None) -> Tree:
    """One mask tree's prune-and-regrow event (single layer).

    masks: the `make_masks` tree; w: the matching recurrent parameter tree
    ({gate: {W, R, b}, theta}); grads: same structure (dense one-step
    scores) for 'rigl'.  Only each gate's W and R are touched; b / theta /
    out masks pass through.  Tensor t of gate i (in mask order, W = 0,
    R = 1) draws its SET scores from `fold_in(fold_in(key, i), t)`, unless
    `scores` ({gate: {W, R}}) gives them."""
    gates = [g for g in masks
             if g not in ("out", "theta") and masks[g] is not None]
    new = {}
    for g, sub in masks.items():
        if g in ("out", "theta") or sub is None:
            new[g] = sub
            continue
        new[g] = dict(sub)
        for ti, t in enumerate(("W", "R")):
            gt = None if grads is None else grads[g][t]
            tkey = None if key is None else \
                fold_in(fold_in(key, gates.index(g)), ti)
            new[g][t] = rewire_tensor(
                sub[t], w[g][t], gt, frac=frac, key=tkey, method=method,
                block=block, scores=None if scores is None else scores[g][t])
    return new


def rewire_stacked_masks(masks: list, ws: list, grads: list | None = None, *,
                         frac: float, key: tuple | None = None,
                         method: str = "rigl", block: int = 1,
                         scores: list | None = None) -> list:
    """Per-layer rewire of a stacked mask list; layer l folds l into the
    event key."""
    return [rewire_masks(masks[l], ws[l],
                         None if grads is None else grads[l], frac=frac,
                         key=None if key is None else fold_in(key, l),
                         method=method, block=block,
                         scores=None if scores is None else scores[l])
            for l in range(len(masks))]
