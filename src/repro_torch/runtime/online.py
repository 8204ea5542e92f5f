"""True online training over an unbounded stream, in PyTorch.

Counterpart of `repro.runtime.online`: :class:`OnlineTrainer` consumes a
step-keyed stream `(x_t, y_t) = stream(t)` and applies an optimizer update
every `update_every` steps — mid-sequence; no sequence boundary exists.
The per-update work is `online_update_chunk`: the learner stepped over the
k-step window, `learner.grads` + optimizer + `reset_grads` (the influence
state carries over).

Not ported yet: checkpoint/resume and failure injection (ROADMAP Queue 1
item 4), rewire (item 8), the stream guard (item 9) and telemetry
(item 11).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.tree import tree_leaves

Tree = Any


def stream_grads(learner, carry: Tree, xs: torch.Tensor, ys: torch.Tensor):
    """Drive the learner over a [k]-step window and read out the gradient.

    Returns (carry, loss, grads, stats) with every stat stacked over the
    window — the online code path's gradient, without the optimizer."""
    per_step = []
    for t in range(xs.shape[0]):
        carry, out = learner.step(carry, xs[t], ys[t])
        per_step.append(out.stats)
    stats = {k: torch.stack([s[k] for s in per_step]) for k in per_step[0]}
    return carry, carry["loss"], learner.grads(carry), stats


def online_update_chunk(learner, opt, carry: Tree, opt_state: Tree,
                        xs: torch.Tensor, ys: torch.Tensor, upd: int):
    """One online update: step through the window, update params
    mid-stream, reset the accumulators.  Returns (carry, opt_state,
    metrics) with loss / alpha / beta / overflow as device scalars."""
    carry, loss, grads, stats = stream_grads(learner, carry, xs, ys)
    params, opt_state = opt.update(grads, opt_state,
                                   learner.params_of(carry), upd)
    carry = learner.reset_grads(carry, params)
    metrics = {"loss": loss}
    for k in ("alpha", "beta"):
        if k in stats:
            metrics[k] = stats[k].mean()
    if "overflow" in stats:
        # max, not mean: any nonzero step means the window's gradients are
        # no longer exact
        metrics["overflow"] = stats["overflow"].max()
    return carry, opt_state, metrics


@dataclasses.dataclass
class OnlineTrainerConfig:
    total_steps: int = 170          # stream steps (not updates)
    update_every: int = 1           # optimizer update every k stream steps
    log_every: int = 10             # keep metrics every N updates
    t_total: float | None = None    # per-step loss scale (None: update_every)


class OnlineTrainer:
    """Streaming trainer over a learner: mid-sequence updates, O(1) memory.

    stream: a step-keyed callable `t -> (x_t [B, ...], y_t [B])` of numpy
    arrays; each window is stacked on the host and copied to `device` once.
    """

    def __init__(self, cfg: OnlineTrainerConfig, learner, opt, params: Tree,
                 masks: Tree | None, stream: Callable[[int], tuple], *,
                 device: torch.device | str):
        self.cfg = cfg
        self.learner = learner
        self.opt = opt
        self.stream = stream
        self.device = torch.device(device)
        x0, y0 = stream(0)
        tt = cfg.t_total if cfg.t_total is not None else float(cfg.update_every)
        self.carry = learner.init(params, masks,
                                  (self._to(x0), self._to(y0)), t_total=tt)
        self.opt_state = opt.init(params)
        self.step = 0                     # stream position
        self.update = 0                   # optimizer updates applied
        self.metrics: list[dict] = []     # every log_every-th window
        self.windows: list[dict] = []     # every window: metrics + wall ms

    def _to(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _gather(self, start: int, k: int):
        xs, ys = zip(*(self.stream(start + i) for i in range(k)))
        return self._to(np.stack(xs)), self._to(np.stack(ys))

    def run(self) -> dict:
        cfg = self.cfg
        while self.step < cfg.total_steps:
            k = min(cfg.update_every, cfg.total_steps - self.step)
            start = self.step
            t0 = time.perf_counter()
            xs, ys = self._gather(start, k)
            self.carry, self.opt_state, m = online_update_chunk(
                self.learner, self.opt, self.carry, self.opt_state, xs, ys,
                self.update)
            # THE window readback: blocks until the device finished the window
            m = {k_: float(v) for k_, v in m.items()}
            dt = time.perf_counter() - t0
            self.windows.append({"ms": dt * 1e3, **m})
            self.step = start + k
            self.update += 1
            if (self.update % cfg.log_every == 0
                    or self.step >= cfg.total_steps):
                self.metrics.append({"update": self.update, "step": self.step,
                                     "dt_s": round(dt, 4), **m})
        return {"final_step": self.step, "updates": self.update,
                "metrics": self.metrics,
                "carry_bytes": carry_nbytes(self.carry),
                "windows": self.windows}


def carry_nbytes(carry: Tree) -> int:
    """Total bytes held by the learner carry — the O(1)-in-stream-length
    memory claim, as a number."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(carry)
                   if isinstance(t, torch.Tensor)))
