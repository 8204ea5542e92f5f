"""The paper's synthetic task (Sec. 6): 2-D spirals unwinding over time,
classified clockwise vs anti-clockwise.

A numpy copy of `repro.data.spiral` (`spiral_dataset` and the batch
iterator `spiral_batches`); its outputs are `array_equal` to the
reference's for the same arguments (tested).
"""
from __future__ import annotations

import numpy as np


def spiral_dataset(n_samples: int = 10_000, T: int = 17, noise: float = 0.05,
                   seed: int = 0):
    """-> xs [N, T, 2] float32, labels [N] int32 (0 = CW, 1 = CCW)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, size=n_samples).astype(np.int32)
    sign = np.where(labels == 1, 1.0, -1.0)
    theta0 = rng.uniform(0, 2 * np.pi, size=n_samples)
    omega = rng.uniform(0.25, 0.55, size=n_samples) * sign     # rad / step
    r0 = rng.uniform(0.1, 0.3, size=n_samples)
    r1 = rng.uniform(0.8, 1.2, size=n_samples)
    t = np.arange(T)[None, :]
    r = r0[:, None] + (r1 - r0)[:, None] * t / (T - 1)
    ang = theta0[:, None] + omega[:, None] * t
    xs = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1)
    xs += noise * rng.standard_normal(xs.shape)
    return xs.astype(np.float32), labels


def spiral_batches(batch_size: int, T: int = 17, n_samples: int = 10_000,
                   seed: int = 0, time_major: bool = True):
    """Infinite batch iterator -> (xs [T, B, 2] (or [B, T, 2]), labels [B]),
    the batch drawn from default_rng(seed + 1)."""
    xs, labels = spiral_dataset(n_samples, T, seed=seed)
    rng = np.random.default_rng(seed + 1)
    n = xs.shape[0]
    while True:
        idx = rng.integers(0, n, size=batch_size)
        xb, yb = xs[idx], labels[idx]
        if time_major:
            xb = np.swapaxes(xb, 0, 1)
        yield xb, yb
