"""Telemetry facade: one object the runtime threads everywhere.

Counterpart of `repro.obs.telemetry`.

`Telemetry` bundles the three observability layers — the host-side
metric `Registry`, the JSONL `EventLog`, and the span `Tracer` — behind
an interface the runtime can call UNCONDITIONALLY:

- `Telemetry.null()` (the default everywhere) keeps a live registry (so
  result dicts and reports always have a consistent source) but writes no
  files and records no spans: `emit` is a no-op, `span` costs one `if`.
- `Telemetry.create(metrics_dir, ...)` turns on the exporters: events go
  to ``events.jsonl`` as they happen; `finalize()` writes the Prometheus
  text exposition (``metrics.prom``), the run manifest
  (``manifest.json``: config + git SHA + final registry snapshot), and —
  when tracing — the Chrome-trace JSON (``trace.json``).

The device-side `MetricPack` layer stays separate (`metricpack.py`)
because it runs inside the update chunks; `record_window` is the host-side
half that lands an unpacked window dict onto the registry under canonical
names.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import time
import uuid
from pathlib import Path

from repro_torch.obs.events import SCHEMA_VERSION, EventLog, sanitize
from repro_torch.obs.registry import Registry
from repro_torch.obs.trace import Tracer

# registry names for the packed per-window metrics (gauges: last window's
# value; the JSONL stream keeps the full history)
WINDOW_GAUGES = ("loss", "grad_norm", "act_sparsity", "bwd_sparsity",
                 "live_col_frac", "kb_min", "kb_mean", "kb_max",
                 "clip_factor", "health")


def git_sha(cwd=None) -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=5)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.TimeoutExpired):    # pragma: no cover
        return None


class Telemetry:
    def __init__(self, registry: Registry, events: EventLog | None,
                 tracer: Tracer, metrics_dir: Path | None,
                 run_id: str, config: dict | None):
        self.registry = registry
        self.events = events
        self.tracer = tracer
        self.metrics_dir = metrics_dir
        self.run_id = run_id
        self.config = config
        self._t_start = time.time()
        self._finalized = False

    # -- constructors -------------------------------------------------------

    @classmethod
    def null(cls) -> "Telemetry":
        """Inert telemetry: registry only, no files, no spans."""
        return cls(Registry(), None, Tracer(enabled=False), None,
                   run_id="null", config=None)

    @classmethod
    def create(cls, metrics_dir, trace: bool = False, run_id: str | None = None,
               config: dict | None = None) -> "Telemetry":
        metrics_dir = Path(metrics_dir)
        metrics_dir.mkdir(parents=True, exist_ok=True)
        run_id = run_id or uuid.uuid4().hex[:12]
        t = cls(Registry(), EventLog(metrics_dir / "events.jsonl"),
                Tracer(enabled=trace), metrics_dir, run_id, config)
        t.emit("run_start", run_id=run_id)
        return t

    @property
    def active(self) -> bool:
        """True when exporters write files (per-window events, per-session
        gauges, and other proportional-cost instrumentation key off this)."""
        return self.events is not None

    # -- the three verbs ----------------------------------------------------

    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    def emit(self, kind: str, **fields):
        if self.events is None:
            return None
        return self.events.emit(kind, **fields)

    def record_window(self, update: int, step: int, dt_ms: float,
                      packed: dict | None = None, **extra):
        """Land one window on the registry (+ JSONL when active): latency
        histogram, per-metric gauges from the unpacked MetricPack dict,
        and a `window` event carrying everything."""
        self.registry.counter("windows_total").inc()
        self.registry.histogram("window_ms").observe(dt_ms)
        fields = dict(update=update, step=step, dt_ms=dt_ms)
        if packed:
            for name in WINDOW_GAUGES:
                v = packed.get(name)
                if v is not None and not (isinstance(v, float)
                                          and math.isnan(v)):
                    self.registry.gauge(name).set(v)
                    fields[name] = v
            ov = packed.get("overflow")
            if ov is not None and not (isinstance(ov, float)
                                       and math.isnan(ov)):
                fields["overflow"] = ov
                if ov > 0:
                    self.registry.counter("overflow_windows_total").inc()
        fields.update(extra)
        self.emit("window", **fields)

    # -- export -------------------------------------------------------------

    def finalize(self, final: dict | None = None,
                 extra_manifest: dict | None = None) -> dict | None:
        """Write metrics.prom + manifest.json (+ trace.json), emit run_end,
        close the event log.  Idempotent; returns the manifest (None for
        null telemetry)."""
        if self.metrics_dir is None or self._finalized:
            return None
        self._finalized = True
        self.emit("run_end", run_id=self.run_id,
                  wall_s=time.time() - self._t_start)
        (self.metrics_dir / "metrics.prom").write_text(
            self.registry.to_prometheus())
        manifest = {
            "schema_version": SCHEMA_VERSION,
            "run_id": self.run_id,
            "git_sha": git_sha(os.getcwd()),
            "created_unix": self._t_start,
            "wall_s": time.time() - self._t_start,
            "config": {k: sanitize(v) for k, v in (self.config or {}).items()},
            "metrics": _clean(self.registry.snapshot()),
            "final": _clean(final or {}),
        }
        (self.metrics_dir / "manifest.json").write_text(
            json.dumps(manifest, indent=2, allow_nan=False))
        if self.tracer.enabled:
            self.tracer.export_chrome(self.metrics_dir / "trace.json")
        if self.events is not None:
            self.events.close()
        return manifest


def _clean(tree):
    """Recursive sanitize for JSON export (allow_nan=False downstream)."""
    if isinstance(tree, dict):
        return {k: _clean(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clean(v) for v in tree]
    return sanitize(tree)
