"""CLI validator for a --metrics-dir artifact directory.

Counterpart of `repro.obs.validate`, with the same checks: a directory
written by either package passes either validator.

    PYTHONPATH=src python -m repro_torch.obs.validate runs/metrics

Checks, in order: ``events.jsonl`` parses and every record conforms to
the event schema; ``manifest.json`` parses and carries the required
keys; ``metrics.prom`` is non-empty text exposition; ``trace.json`` (if
present) is Chrome-trace JSON with a ``traceEvents`` list.  Exit 0 on a
clean directory, 1 with a reason otherwise.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from repro_torch.obs.events import SchemaError, read_events

MANIFEST_KEYS = ("schema_version", "run_id", "config", "metrics")


def validate_dir(metrics_dir) -> list[str]:
    """Return problems (empty list == valid)."""
    d = Path(metrics_dir)
    problems: list[str] = []
    if not d.is_dir():
        return [f"{d}: not a directory"]

    ev = d / "events.jsonl"
    if not ev.exists():
        problems.append(f"{ev}: missing")
    else:
        try:
            recs = read_events(ev)
            if not recs:
                problems.append(f"{ev}: empty event stream")
            elif recs[0]["kind"] != "run_start":
                problems.append(f"{ev}: first record is {recs[0]['kind']!r}, "
                                "expected run_start")
        except SchemaError as e:
            problems.append(str(e))

    man = d / "manifest.json"
    if not man.exists():
        problems.append(f"{man}: missing")
    else:
        try:
            doc = json.loads(man.read_text())
            for k in MANIFEST_KEYS:
                if k not in doc:
                    problems.append(f"{man}: missing key {k!r}")
        except json.JSONDecodeError as e:
            problems.append(f"{man}: not JSON: {e}")

    prom = d / "metrics.prom"
    if not prom.exists():
        problems.append(f"{prom}: missing")
    elif not prom.read_text().strip():
        problems.append(f"{prom}: empty")

    tr = d / "trace.json"
    if tr.exists():
        try:
            doc = json.loads(tr.read_text())
            if not isinstance(doc.get("traceEvents"), list):
                problems.append(f"{tr}: no traceEvents list")
        except json.JSONDecodeError as e:
            problems.append(f"{tr}: not JSON: {e}")

    return problems


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.validate <metrics_dir>",
              file=sys.stderr)
        return 2
    problems = validate_dir(argv[0])
    if problems:
        for p in problems:
            print(f"INVALID: {p}", file=sys.stderr)
        return 1
    print(f"ok: {argv[0]} is a valid metrics directory")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
