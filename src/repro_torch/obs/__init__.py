"""Telemetry plane of the port (counterpart of `repro.obs`).

Three layers:

- `MetricPack` — device-side metrics packing: all per-window scalars
  stacked into one tensor by the update chunk, one device->host readback,
  bit-identical chunk outputs (`repro_torch.obs.metricpack`).
- `Registry` / `EventLog` — host-side counters, gauges, fixed-bucket
  histograms (interpolated p50/p95/p99), schema-versioned JSONL events,
  Prometheus text exposition (`repro_torch.obs.registry`,
  `repro_torch.obs.events`).
- `Tracer` — nested wall-clock spans with Chrome-trace export and
  optional `torch.profiler.record_function` passthrough
  (`repro_torch.obs.trace`).

`Telemetry` (`repro_torch.obs.telemetry`) bundles the host-side layers
behind a facade with a no-op `null()` form, so the runtime instruments
unconditionally and the exporters cost nothing until `--metrics-dir`
turns them on.  The host-side layers are pure Python copies of the
reference's: the same calls write the same text, and a metrics directory
of either package validates under the other's validator.
"""
from repro_torch.obs.cli import add_obs_args, finish_run, telemetry_from_args
from repro_torch.obs.events import (KIND_FIELDS, SCHEMA_VERSION, EventLog,
                                    SchemaError, read_events)
from repro_torch.obs.metricpack import DEFAULT_FIELDS, MetricPack
from repro_torch.obs.registry import (DEFAULT_LATENCY_BUCKETS_MS, Counter,
                                      Gauge, Histogram, Registry)
from repro_torch.obs.summary import format_summary, print_summary
from repro_torch.obs.telemetry import Telemetry, git_sha
from repro_torch.obs.trace import Tracer

__all__ = [
    "Counter", "DEFAULT_FIELDS", "DEFAULT_LATENCY_BUCKETS_MS", "EventLog",
    "Gauge", "Histogram", "KIND_FIELDS", "MetricPack", "Registry",
    "SCHEMA_VERSION", "SchemaError", "Telemetry", "Tracer", "add_obs_args",
    "finish_run", "format_summary", "git_sha", "print_summary",
    "read_events", "telemetry_from_args",
]
