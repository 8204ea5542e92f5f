"""Host-side metrics registry: counters, gauges, and fixed-bucket
histograms with O(1) memory and no stored samples.

Counterpart of `repro.obs.registry`, pure Python: the same calls give the
same snapshot and the same Prometheus text.

The registry is the ONE place runtime health numbers live: the online
trainer, the stream guard, the fleet, and the launch summaries all read
and write the same named metrics, so a run's result dict, its Prometheus
exposition, and its run manifest can never disagree on a value (they are
all views of this object).

Design constraints, in order:

- **Cheap enough for the hot loop.**  A counter inc is a dict lookup and a
  float add; gauges likewise.  Histograms bucket-index with `bisect` —
  no sample list ever grows, so a week-long stream costs the same memory
  as a smoke run.
- **Percentiles without samples.**  `Histogram.quantile` linearly
  interpolates inside the fixed bucket the target rank falls in — the
  standard Prometheus estimator.  Error is bounded by the bucket width
  (tests/test_torch_obs.py pins it against numpy on known samples).
- **Prometheus text exposition** (`to_prometheus`): the de-facto scrape
  format, so a run's final metrics file drops straight into promtool /
  Grafana without an agent.
"""
from __future__ import annotations

import bisect
import math
from typing import Iterable

# geometric ladder, 100us .. 60s: wide enough for a per-step latency and a
# whole-window wall clock to share one default
DEFAULT_LATENCY_BUCKETS_MS = (
    0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0, 10000.0, 30000.0, 60000.0)


class Counter:
    """Monotonic event count.  `inc` only; `add` exists so a resumed run
    can fast-forward the count to its checkpointed value."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        self.value += n

    def add(self, n: float):
        self.inc(n)


class Gauge:
    """Last-write-wins scalar (loss, sparsity, bytes, ...)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = float("nan")

    def set(self, v: float):
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: cumulative-style export, interpolated
    quantiles, no stored samples.

    `edges` are the bucket UPPER bounds (strictly increasing); an implicit
    +Inf bucket catches the tail.  `quantile(q)` finds the bucket holding
    rank q * count and interpolates linearly inside it — within the first
    bucket the lower edge is the observed min (tighter than 0), within the
    overflow bucket it returns the observed max (the only bound we have).
    """
    __slots__ = ("edges", "counts", "sum", "count", "min", "max")

    def __init__(self, edges: Iterable[float] = DEFAULT_LATENCY_BUCKETS_MS):
        self.edges = tuple(float(e) for e in edges)
        if not self.edges or any(b <= a for a, b in zip(self.edges,
                                                        self.edges[1:])):
            raise ValueError("histogram edges must be non-empty and "
                             f"strictly increasing, got {self.edges}")
        self.counts = [0] * (len(self.edges) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float):
        v = float(v)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def quantile(self, q: float) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return float("nan")
        target = q * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c > 0:
                lo = self.min if i == 0 else self.edges[i - 1]
                hi = self.max if i == len(self.edges) else self.edges[i]
                lo, hi = min(lo, hi), max(hi, lo)
                frac = (target - cum) / c
                return lo + (hi - lo) * frac
            cum += c
        return self.max          # q == 1.0 landing past the last nonempty

    def percentiles(self) -> dict:
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + body + "}"


class Registry:
    """Named metrics, get-or-create, optional labels.

    `counter("guard_faults_total")`, `gauge("loss")`,
    `histogram("window_ms", buckets=...)`, plus `gauge("session_loss",
    sid="u17")`-style labelled series.  Re-registering a name with a
    different type raises — a name means one thing."""

    def __init__(self):
        self._metrics: dict = {}      # (name, labelkey) -> metric
        self._types: dict = {}        # name -> "counter"|"gauge"|"histogram"

    def _get(self, kind: str, name: str, labels: dict, factory):
        have = self._types.get(name)
        if have is not None and have != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{have}, requested {kind}")
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = factory()
            self._metrics[key] = m
            self._types[name] = kind
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(buckets if buckets is not None
                                           else DEFAULT_LATENCY_BUCKETS_MS))

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """{name{labels}: value} — histograms expand to count/sum/min/max +
        interpolated p50/p95/p99.  Non-finite values pass through (the JSON
        writers sanitize them)."""
        out = {}
        for (name, labels), m in sorted(self._metrics.items()):
            key = name + _label_str(labels)
            if isinstance(m, Histogram):
                out[key] = {"count": m.count, "sum": m.sum,
                            "min": m.min if m.count else float("nan"),
                            "max": m.max if m.count else float("nan"),
                            **m.percentiles()}
            else:
                out[key] = m.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (one `# TYPE` header per family,
        cumulative `_bucket{le=...}` series for histograms)."""
        by_name: dict = {}
        for (name, labels), m in sorted(self._metrics.items()):
            by_name.setdefault(name, []).append((labels, m))
        lines = []
        for name, series in by_name.items():
            kind = self._types[name]
            lines.append(f"# TYPE {name} {kind}")
            for labels, m in series:
                ls = _label_str(labels)
                if isinstance(m, Histogram):
                    cum = 0
                    for i, edge in enumerate(m.edges):
                        cum += m.counts[i]
                        le = _label_str(labels + (("le", f"{edge:g}"),))
                        lines.append(f"{name}_bucket{le} {cum}")
                    le = _label_str(labels + (("le", "+Inf"),))
                    lines.append(f"{name}_bucket{le} {m.count}")
                    lines.append(f"{name}_sum{ls} {m.sum:g}")
                    lines.append(f"{name}_count{ls} {m.count}")
                else:
                    v = m.value
                    txt = f"{v:g}" if math.isfinite(v) else \
                        ("NaN" if math.isnan(v) else
                         ("+Inf" if v > 0 else "-Inf"))
                    lines.append(f"{name}{ls} {txt}")
        return "\n".join(lines) + ("\n" if lines else "")
