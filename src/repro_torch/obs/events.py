"""Schema-versioned JSONL event log — one record per window or event.

Counterpart of `repro.obs.events`.  The schema is data, copied as it is:
a file written by either package validates under the other's validator.

Every record carries the envelope ``{"v": SCHEMA_VERSION, "kind": ...,
"ts": unix_seconds}`` plus kind-specific required fields (KIND_FIELDS).
Records are validated BEFORE they are written, so a stream that parses is
a stream that conforms — downstream consumers (the CI validator, the
trajectory aggregator, ad-hoc pandas) never need defensive parsing.

Values are sanitized to JSON-clean scalars: numpy scalars unwrap, NaN/Inf
become null (strict JSON has no NaN, and a silent ``NaN`` literal breaks
every non-Python consumer).
"""
from __future__ import annotations

import json
import math
import time
from pathlib import Path

SCHEMA_VERSION = 1

# kind -> required fields beyond the envelope.  Extra fields are always
# allowed (the schema is a floor, not a ceiling).
KIND_FIELDS = {
    "run_start": ("run_id",),
    "run_end": ("run_id",),
    "window": ("update", "step", "dt_ms"),          # one per update window
    "rewire": ("event", "frac", "ms"),              # prune-and-regrow event
    "fault": ("reason", "step", "attempt"),         # guard detection
    "rollback": ("to_step", "to_update"),           # guard ring restore
    "recovery": ("step", "action", "attempts"),     # window healed
    "quarantine": ("start", "len", "update"),       # window inputs dropped
    "ckpt_write": ("step",),                        # checkpoint scheduled
    "session_join": ("sid", "slot"),                # fleet slot claimed
    "session_leave": ("sid", "slot"),               # fleet slot freed
    "session_evict": ("sid", "pos"),                # persisted to the store
    "session_resume": ("sid", "slot", "pos"),       # loaded back
    "fleet_window": ("window", "live", "dt_ms"),    # one per fleet window
}

_ENVELOPE = ("v", "kind", "ts")


class SchemaError(ValueError):
    """A record that does not conform to the event schema."""


def sanitize(value):
    """JSON-clean scalar: numpy unwraps via item(), non-finite -> None."""
    if hasattr(value, "item") and not isinstance(value, (str, bytes)):
        try:
            value = value.item()
        except (TypeError, ValueError):
            value = str(value)
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


def validate_record(rec: dict):
    """Raise SchemaError unless `rec` is a conforming event record."""
    if not isinstance(rec, dict):
        raise SchemaError(f"record must be an object, got {type(rec)}")
    for k in _ENVELOPE:
        if k not in rec:
            raise SchemaError(f"record missing envelope field {k!r}: {rec}")
    if rec["v"] != SCHEMA_VERSION:
        raise SchemaError(f"schema version {rec['v']!r} != {SCHEMA_VERSION}")
    kind = rec["kind"]
    if kind not in KIND_FIELDS:
        raise SchemaError(f"unknown event kind {kind!r} "
                          f"(known: {sorted(KIND_FIELDS)})")
    if not isinstance(rec["ts"], (int, float)):
        raise SchemaError(f"ts must be numeric, got {rec['ts']!r}")
    missing = [f for f in KIND_FIELDS[kind] if f not in rec]
    if missing:
        raise SchemaError(f"{kind!r} record missing fields {missing}: {rec}")


class EventLog:
    """Append-only JSONL writer.  `emit` builds the envelope, sanitizes,
    validates, writes one line, and returns the record it wrote."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")
        self.written = 0

    def emit(self, kind: str, **fields) -> dict:
        rec = {"v": SCHEMA_VERSION, "kind": kind, "ts": time.time()}
        rec.update({k: sanitize(v) for k, v in fields.items()})
        validate_record(rec)
        self._f.write(json.dumps(rec, allow_nan=False) + "\n")
        self._f.flush()
        self.written += 1
        return rec

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


def read_events(path, validate: bool = True) -> list[dict]:
    """Parse a JSONL event stream back, validating every record (the
    round trip that `repro_torch.obs.validate` exercises)."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise SchemaError(f"{path}:{i + 1}: not JSON: {e}") from e
            if validate:
                validate_record(rec)
            out.append(rec)
    return out
