"""Idle gaps of a reduced trace summed by the program's span that names
them.

`bench.trace` names every idle gap of the device by the innermost host
range open at its middle.  The program's spans (`repro_torch.obs.trace`:
`window`, `rewire`, `ckpt_write`, `rollback_replay`, and the phases
`trainer.*`, `engine.*`, `k1.launch`) are host ranges under the profiler,
so a gap where the host ran the program's own Python carries the name of
the phase it was in.
"""
from __future__ import annotations

WINDOW_SPANS = ("window", "rewire", "ckpt_write", "rollback_replay")
PHASE_PREFIXES = ("trainer.", "engine.", "k1.")


def is_program_span(name: str) -> bool:
    return name in WINDOW_SPANS or name.startswith(PHASE_PREFIXES)


def idle_seconds(red: dict | None, match) -> float | None:
    """Seconds of the gaps whose name `match` accepts.  None without a
    trace, where the device ran nothing, or where no gap carries a program
    span's name (a program without spans: there is nothing to split)."""
    if red is None or red["ops"] == 0:
        return None
    gaps = red["gaps"]
    if not any(is_program_span(name) for name, _ in gaps):
        return None
    return sum(sec for name, sec in gaps if match(name))
