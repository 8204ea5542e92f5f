"""Span tracing: nested wall-clock spans with Chrome-trace export.

Counterpart of `repro.obs.trace`.  `span(name)` (this module's) and
`Tracer.span(name)` hand out context managers around one phase of the
program; the two go through the same code.

- Under any running `torch.profiler` session a span is a host range of its
  name: a CPU op in ``prof.events()`` (``is_user_annotation`` False) that
  holds the ops its body issued, whether or not a Tracer records it.  It
  enters `torch._C._profiler._RecordFunctionFast`, not
  `torch.profiler.record_function`: the latter is a user annotation, which
  the profiler mirrors on the device's timeline as a CUDA-typed event, so a
  reader that counts the device's events would count the span.
- Inside a span of an enabled `Tracer` (``--metrics-dir --trace``) every
  span, this module's included, also lands in that Tracer's bounded list
  (name, start, duration, nesting depth, args), stamped in integer
  microseconds of Unix time: the profiler's clock (an event's
  ``time_range.start`` plus ``trace_start_ns`` / 1e3, or a Chrome export's
  ``ts`` plus ``baseTimeNanoseconds`` / 1e3), so the Tracer's
  ``trace.json`` overlays a profiler trace of the same run.  Load it in
  ``chrome://tracing`` (or Perfetto): the run's windows, their phases,
  rewires, rollback replays and checkpoint writes lay out on one timeline.
- With no profiler session and no enabled Tracer's span open, `span`
  returns a shared no-op context after two flag reads, and records
  nothing.

Deep call sites (the step engine, the K1 wrapper) hold no `Telemetry`: they
call `span` here, and the Tracer whose span encloses them records them (a
context variable, set only while an enabled Tracer's span is open, so
another thread never records into it).
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import time
from pathlib import Path

import torch

# bound memory on unbounded streams: keep the first MAX_SPANS spans and
# count the rest (the shape of a steady-state loop is visible early)
MAX_SPANS = 200_000

_profiling = torch._C._autograd._profiler_enabled
_HostRange = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()
# the enabled Tracer whose span is open, which records the spans inside
_TRACER: contextvars.ContextVar = contextvars.ContextVar("repro_torch_tracer",
                                                         default=None)


def span(name: str, /, **args):
    """A span of `name` around a phase: a host range under a profiler
    session, and a record of the enclosing enabled Tracer's, if any."""
    tracer = _TRACER.get()
    if tracer is None and not _profiling():
        return _NULL
    return _Span(name, tracer, args)


class _Span:
    __slots__ = ("name", "tracer", "args", "_range", "_t0", "_token")

    def __init__(self, name: str, tracer: "Tracer | None", args: dict):
        self.name, self.tracer, self.args = name, tracer, args
        self._range = None

    def __enter__(self):
        if _profiling():
            self._range = _HostRange(self.name)
            self._range.__enter__()
        tracer = self.tracer
        if tracer is not None:
            self._token = _TRACER.set(tracer)
            tracer._stack.append(self.name)
            self._t0 = time.time_ns()

    def __exit__(self, *exc):
        tracer = self.tracer
        if tracer is not None:
            t1 = time.time_ns()
            depth = len(tracer._stack) - 1
            tracer._stack.pop()
            _TRACER.reset(self._token)
            tracer._record(self.name, self._t0, t1, depth, self.args)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


class Tracer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: list[dict] = []
        self.dropped = 0
        self._stack: list[str] = []

    def span(self, name: str, **args):
        """`span(name)`, recorded here (with `args`) when enabled."""
        if self.enabled:
            return _Span(name, self, args)
        return span(name, **args)

    def _record(self, name: str, t0_ns: int, t1_ns: int, depth: int,
                args: dict) -> None:
        if len(self.spans) < MAX_SPANS:
            ts = t0_ns // 1000
            self.spans.append({"name": name, "ts": ts,
                               "dur": t1_ns // 1000 - ts, "depth": depth,
                               "args": args})
        else:
            self.dropped += 1

    def export_chrome(self, path) -> Path:
        """Write Chrome trace-event JSON (``chrome://tracing`` loads it).
        Complete events ("ph": "X") stamped in Unix-epoch microseconds;
        nesting falls out of the containment of [ts, ts + dur] intervals."""
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
