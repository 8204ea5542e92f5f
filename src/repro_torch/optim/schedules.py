"""Learning-rate schedules: host step -> lr (counterpart of
`repro.optim.schedules`).

The step is the host integer update count here, so a schedule is float32
arithmetic on the host (numpy, rounded as the reference's jnp float32
ops are), and the update reads a Python float."""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def constant(lr: float):
    return lambda step: float(_f32(lr))


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        s = _f32(step)
        return float(_f32(lr) * min(_f32(1.0), (s + _f32(1)) / _f32(max(1, warmup_steps))))
    return f


def cosine_warmup(lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = min(_f32(1.0), (s + _f32(1)) / _f32(max(1, warmup_steps)))
        prog = np.clip((s - _f32(warmup_steps))
                       / _f32(max(1, total_steps - warmup_steps)),
                       _f32(0.0), _f32(1.0))
        cos = _f32(min_ratio) + _f32(1 - min_ratio) * _f32(0.5) * (
            _f32(1) + np.cos(_f32(np.pi) * prog))
        return float(_f32(lr) * warm * cos)
    return f
