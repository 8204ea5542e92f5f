"""The port's fault-tolerant Trainer and restart supervisor
(`repro_torch.runtime.trainer`): the JAX package's cases
(tests/test_fault_tolerance.py) on a least-squares problem in torch, plus
the supervisor's retry policy and checkpoint cadence."""
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointError, load_checkpoint
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.runtime.trainer import (InjectedFailure, Trainer,
                                         TrainerConfig, run_with_restart)


def _quad_setup(tmp_path, fail_at=-1, steps=12, ckpt_every=4, **cfg_kw):
    opt = make_optimizer("adamw", lr=1e-2)

    def step_fn(params, opt_state, batch, step):
        w = params["w"]
        r = w @ batch["x"] - batch["y"]
        loss = r.square().mean()
        grads = {"w": 2.0 * r @ batch["x"].T / r.numel()}
        params, opt_state = opt.update(grads, opt_state, params, step)
        return params, opt_state, {"loss": loss}

    def data_at(step):                    # deterministic per step
        g = torch.Generator().manual_seed(step)
        return {"x": torch.randn(4, 4, generator=g),
                "y": torch.randn(3, 4, generator=g)}

    def make_trainer(attempt=0):
        params = {"w": torch.ones(3, 4)}
        cfg = TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                            ckpt_dir=str(tmp_path),
                            fail_at_step=fail_at if attempt == 0 else -1,
                            log_every=1, **cfg_kw)
        return Trainer(cfg, step_fn, params, opt.init(params), data_at)

    return make_trainer


_LIKE = {"params": {"w": torch.zeros(3, 4)},
         "opt": {"m": {"w": torch.zeros(3, 4)}, "v": {"w": torch.zeros(3, 4)}}}


def test_crash_restart_resume(tmp_path):
    out = run_with_restart(_quad_setup(tmp_path, fail_at=7))
    assert out["final_step"] == 12
    assert out["restarts"] == 1
    # the restart resumed from step 4 (the last checkpoint before 7)
    assert [s["step"] for s in out["steps"]] == list(range(5, 13))


def test_restart_is_deterministic(tmp_path):
    """A crash and resume ends where an uninterrupted run ends, bit for
    bit (step-keyed data, exact resume)."""
    out_a = run_with_restart(_quad_setup(tmp_path / "a", fail_at=7))
    out_b = run_with_restart(_quad_setup(tmp_path / "b"))
    ta, sa = load_checkpoint(tmp_path / "a", _LIKE)
    tb, sb = load_checkpoint(tmp_path / "b", _LIKE)
    assert sa == sb == 12
    for k in ("m", "v"):
        assert torch.equal(ta["opt"][k]["w"], tb["opt"][k]["w"])
    assert torch.equal(ta["params"]["w"], tb["params"]["w"])
    tail = {s["step"]: s["loss"] for s in out_b["steps"]}
    assert all(s["loss"] == tail[s["step"]] for s in out_a["steps"])


def test_exceeding_max_restarts_raises(tmp_path):
    mk = _quad_setup(tmp_path, fail_at=2)
    attempts = []

    def make_always_fail(attempt=0):
        attempts.append(attempt)
        return mk(0)                      # failure armed every attempt

    with pytest.raises(InjectedFailure):
        run_with_restart(make_always_fail, max_restarts=2)
    assert attempts == [0, 1, 2]


def test_straggler_counter(tmp_path):
    t = _quad_setup(tmp_path, steps=6)()
    t.cfg.straggler_factor = 0.0          # every step counts as a straggler
    out = t.run()
    assert out["stragglers"] >= 5


def test_factory_without_attempt_and_non_retryable_errors(tmp_path):
    mk = _quad_setup(tmp_path / "a", steps=3)
    out = run_with_restart(lambda: mk(0))          # TypeError fallback
    assert out["final_step"] == 3 and out["restarts"] == 0

    mk = _quad_setup(tmp_path / "b", steps=3)
    calls = []

    def broken(attempt=0):
        calls.append(attempt)
        t = mk(0)
        t.step_fn = lambda *a: (_ for _ in ()).throw(ValueError("bad data"))
        return t

    with pytest.raises(ValueError, match="bad data"):
        run_with_restart(broken)
    assert calls == [0]                    # not retryable: no restart

    mk = _quad_setup(tmp_path / "c", steps=3)
    flaky = {"n": 0}

    def write_breaks_once(attempt=0):
        t = mk(attempt)
        if flaky["n"] == 0:
            flaky["n"] += 1
            t.save = lambda: (_ for _ in ()).throw(CheckpointError("disk"))
        return t

    out = run_with_restart(write_breaks_once, backoff_s=1e-3)
    assert out["restarts"] == 1


def test_ckpt_every_zero_keeps_only_the_final_save(tmp_path):
    """ckpt_every <= 0: no periodic checkpoint (no modulo by zero); the
    final save at the end of run stays, and a rerun resumes at its end."""
    mk = _quad_setup(tmp_path, steps=5, ckpt_every=0,
                     metrics_path=str(tmp_path / "m.jsonl"))
    out = run_with_restart(mk)
    assert out["final_step"] == 5
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000005"]
    recs = [json.loads(line) for line in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5]
    assert np.isfinite([r["loss"] for r in recs]).all()
    again = run_with_restart(mk)
    assert again["final_step"] == 5 and again["steps"] == []
