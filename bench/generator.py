"""The one traffic generator: a mix is a data file under `bench/traffic/`,
found by its name, and this module turns it and a seed into inputs.

A mix of kind "stream" is an unbounded step-keyed stream for an online
learner, closed loop (the learner takes step t + 1 when it is done with
step t):

    {"kind": "stream", "loop": "closed",
     "inputs": {"dist": "normal", "sigma": 8.0},
     "labels": {"dist": "uniform"}}

Step t's inputs [batch, n_in] and labels [batch] come from a numpy
generator seeded by (seed, t) alone, so a run, its reference and a
restarted run see the same rows, and no two steps share a row.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load_mix(name: str) -> dict:
    """The mix `name` (bench/traffic/<name>.json)."""
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} at {path}")
    mix = json.loads(path.read_text())
    mix.setdefault("name", name)
    return mix


def _inputs(spec: dict, rng: np.random.Generator, shape) -> np.ndarray:
    if spec["dist"] != "normal":
        raise ValueError(f"input distribution {spec['dist']!r} is not one "
                         "the generator draws (normal)")
    x = rng.standard_normal(shape, dtype=np.float32)
    return np.float32(spec["sigma"]) * x


def _labels(spec: dict, rng: np.random.Generator, batch: int,
            n_classes: int) -> np.ndarray:
    if spec["dist"] != "uniform":
        raise ValueError(f"label distribution {spec['dist']!r} is not one "
                         "the generator draws (uniform)")
    return rng.integers(0, n_classes, size=batch, dtype=np.int64)


def make_stream(mix: dict, *, seed: int, batch: int, n_in: int,
                n_classes: int):
    """The step-keyed stream t -> (x_t [batch, n_in] f32, y_t [batch] i64)
    of a mix of kind "stream"."""
    if mix.get("kind") != "stream":
        raise ValueError(f"mix {mix.get('name')!r} is of kind "
                         f"{mix.get('kind')!r}: the generator makes streams")
    if mix.get("loop", "closed") != "closed":
        raise ValueError("a stream is consumed as fast as the learner runs: "
                         "loop must be 'closed'")
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be a whole number >= 0, got {seed}")

    def stream(t: int):
        rng = np.random.default_rng((seed, int(t)))
        x = _inputs(mix["inputs"], rng, (batch, n_in))
        return x, _labels(mix["labels"], rng, batch, n_classes)

    return stream


def stack(stream, start: int, steps: int):
    """Steps [start, start + steps) of a stream, stacked: (xs [T, B, n_in],
    ys [T, B])."""
    xs, ys = zip(*(stream(start + t) for t in range(steps)))
    return np.stack(xs), np.stack(ys)
