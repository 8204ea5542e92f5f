"""Fault-tolerant training loop, in PyTorch.

Counterpart of `repro.runtime.trainer`:
  * periodic async checkpoints (atomic, `keep` retained) of params and
    optimizer state, and a final one at the end of `run`;
  * auto-resume from the latest valid checkpoint (params, opt state, step);
  * failure injection (a crash at step K, once) and a supervised restart;
  * a straggler watchdog: a step slower than `straggler_factor` x the EMA
    of step wall times is counted;
  * step-keyed data (`data_it(step)`), so a restart replays exactly;
  * elastic re-mesh: `shardings` = (param shardings, opt shardings), the
    TARGET placements a resume restores onto (`checkpoint.load_checkpoint`;
    possibly another mesh shape than the writer's).
"""
from __future__ import annotations

import dataclasses
import json
import tempfile
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointError, CheckpointManager


class InjectedFailure(RuntimeError):
    pass


# restart-from-checkpoint is the right response to a crash or a broken
# checkpoint write, not to a fault that a deterministic replay would meet
# again
RETRYABLE = (InjectedFailure, CheckpointError)


def default_ckpt_dir(name: str = "repro_torch_ckpt") -> str:
    """The port's own default checkpoint root, `<tempdir>/<name>`: never
    the JAX package's /tmp/repro_ckpt, so the port does not resume by
    accident from a checkpoint the JAX launcher wrote."""
    return str(Path(tempfile.gettempdir()) / name)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20            # <= 0: no periodic checkpoint
    ckpt_dir: str | None = None     # None: default_ckpt_dir()
    keep: int = 3
    log_every: int = 10
    fail_at_step: int = -1          # failure injection (once)
    straggler_factor: float = 3.0
    metrics_path: str | None = None


def scalar_metrics(m: dict) -> dict:
    """Metrics -> host floats, a non-scalar one mean-reduced: the step's
    readback, which waits for the device.  The tensors are stacked and read
    back at once: one device sync, whatever the number of metrics."""
    out = dict.fromkeys(m)
    tensors = {k: (v if v.numel() == 1 else v.float().mean()).reshape(())
               for k, v in m.items() if isinstance(v, torch.Tensor)}
    if tensors:
        vals = torch.stack([v.float() for v in tensors.values()]).tolist()
        out.update(zip(tensors, vals))
    for k, v in m.items():
        if not isinstance(v, torch.Tensor):
            out[k] = float(np.mean(v))
    return out


class Trainer:
    """Whole-sequence training with checkpoints and a crash-restart path.

    step_fn(params, opt_state, batch, step) -> (params, opt_state, metrics);
    data_it: an iterator, or a callable step -> batch (deterministic replay
    across restarts)."""

    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 params: Any, opt_state: Any, data_it,
                 shardings: tuple | None = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.data_it = data_it
        self.shardings = shardings             # (param_sh, opt_sh) for re-mesh
        self.ckpt = CheckpointManager(cfg.ckpt_dir or default_ckpt_dir(),
                                      keep=cfg.keep)
        self.step = 0
        self.stragglers = 0
        self._ema = None
        self._failed_once = False
        self.metrics: list[dict] = []     # every log_every-th step
        self.steps: list[dict] = []       # every step: metrics + wall ms

    # -- checkpoint/restore -------------------------------------------------

    def _ckpt_tree(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def save(self):
        self.ckpt.save(self.step, self._ckpt_tree(),
                       extra={"step": self.step})

    def try_resume(self) -> bool:
        if self.ckpt.latest_step() < 0:
            return False
        sh = None
        if self.shardings is not None:
            sh = {"params": self.shardings[0], "opt": self.shardings[1]}
        tree, step = self.ckpt.restore(self._ckpt_tree(), sh)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step = step
        return True

    # -- loop ---------------------------------------------------------------

    def run(self) -> dict:
        cfg = self.cfg
        while self.step < cfg.total_steps:
            if self.step == cfg.fail_at_step and not self._failed_once:
                self._failed_once = True
                # land the pending write first, so that the restart resumes
                # from it and the replay is the same on every run; a real
                # crash can lose that write, and valid_steps covers that
                self.ckpt.wait()
                raise InjectedFailure(f"injected failure at step {self.step}")
            if callable(self.data_it):
                batch = self.data_it(self.step)   # step-keyed: replay-exact
            else:
                batch = next(self.data_it)
            t0 = time.perf_counter()
            self.params, self.opt_state, m = self.step_fn(
                self.params, self.opt_state, batch, self.step)
            m = scalar_metrics(m)
            dt = time.perf_counter() - t0
            self._watch_straggler(dt)
            self.step += 1
            self.steps.append({"step": self.step, "ms": dt * 1e3, **m})
            if cfg.ckpt_every > 0 and self.step % cfg.ckpt_every == 0:
                self.save()
            if self.step % cfg.log_every == 0 or self.step == cfg.total_steps:
                rec = {"step": self.step, "dt_s": round(dt, 4), **m}
                self.metrics.append(rec)
                if cfg.metrics_path:
                    with open(cfg.metrics_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
        self.save()
        self.ckpt.wait()
        return {"final_step": self.step, "stragglers": self.stragglers,
                "metrics": self.metrics, "steps": self.steps}

    def _watch_straggler(self, dt: float):
        if self._ema is None:
            self._ema = dt
        if dt > self.cfg.straggler_factor * self._ema:
            self.stragglers += 1
        self._ema = 0.9 * self._ema + 0.1 * dt


def run_with_restart(make_trainer: Callable[..., Any],
                     max_restarts: int = 3, retryable: tuple | None = None,
                     backoff_s: float = 0.0,
                     max_backoff_s: float = 30.0) -> dict:
    """Supervisor: restart from the latest checkpoint on failure.

    `make_trainer(attempt)` lets callers disarm one-shot failure injection
    on restarted attempts (a factory that takes no argument is called
    without one).  `retryable` is the exception set worth a restart
    (default :data:`RETRYABLE`); anything else propagates at once.
    `backoff_s` > 0 sleeps backoff_s * 2^(attempt-1), capped at
    max_backoff_s, between restarts."""
    retryable = RETRYABLE if retryable is None else tuple(retryable)
    restarts = 0
    while True:
        try:
            trainer = make_trainer(restarts)
        except TypeError:
            trainer = make_trainer()
        trainer.try_resume()
        try:
            out = trainer.run()
            out["restarts"] = restarts
            return out
        except retryable:
            restarts += 1
            if restarts > max_restarts:
                raise
            if backoff_s > 0:
                time.sleep(min(backoff_s * (2 ** (restarts - 1)),
                               max_backoff_s))
