"""Span tracing: nested wall-clock spans with Chrome-trace export.

Counterpart of `repro.obs.trace`.  A `Tracer` hands out `span("window")`
context managers; completed spans record (name, start, duration, nesting
depth, args) into a bounded list and export as Chrome trace-event JSON —
load the file in ``chrome://tracing`` (or Perfetto) and the run's windows,
rewires, rollback replays, and checkpoint writes lay out on one timeline.

Every recorded span also enters a `torch.profiler.record_function` of
its name, so under a `torch.profiler` session the host spans line up
against the device ops they issued (the reference passes its spans to
`jax.profiler.TraceAnnotation` the same way).  Without a profiler session
the annotation records nothing.

Disabled tracers (`Tracer(enabled=False)`) make `span(...)` a zero-record
no-op — the runtime can call it unconditionally.
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

# bound memory on unbounded streams: keep the first MAX_SPANS spans and
# count the rest (the shape of a steady-state loop is visible early)
MAX_SPANS = 200_000


class Tracer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: list[dict] = []
        self.dropped = 0
        self._stack: list[str] = []
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, **args):
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function
        self._stack.append(name)
        t0 = self._now_us()
        try:
            with record_function(name):
                yield
        finally:
            dur = self._now_us() - t0
            depth = len(self._stack) - 1
            self._stack.pop()
            if len(self.spans) < MAX_SPANS:
                self.spans.append({"name": name, "ts": t0, "dur": dur,
                                   "depth": depth, "args": args})
            else:
                self.dropped += 1

    def export_chrome(self, path) -> Path:
        """Write Chrome trace-event JSON (``chrome://tracing`` loads it).
        Complete events ("ph": "X") with microsecond timestamps; nesting
        falls out of the containment of [ts, ts + dur] intervals."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        events = [{"name": s["name"], "ph": "X", "ts": s["ts"],
                   "dur": s["dur"], "pid": 0, "tid": 0,
                   "args": {k: _jsonable(v) for k, v in s["args"].items()}}
                  for s in self.spans]
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if self.dropped:
            doc["droppedSpans"] = self.dropped
        path.write_text(json.dumps(doc))
        return path


def _jsonable(v):
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        try:
            return v.item()
        except (TypeError, ValueError, RuntimeError):
            return str(v)
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
