"""engine.span_idle_ms_per_step: device idle time a stream step while the
host runs the step engine's own Python between launches, in ms.

The idle gaps named `engine.*` or `k1.launch` (the cell's partials, the
row compaction, the M-bar rows, K1's wrapper, the readout, the gradient,
the window's gradient read and the update), over the traced stream
steps."""
from bench import span_gaps


def read(ctx):
    steps = ctx.get("steps", 0)
    sec = span_gaps.idle_seconds(
        ctx.get("trace"),
        lambda name: name.startswith("engine.") or name == "k1.launch")
    if sec is None or steps <= 0:
        return None
    return sec / steps * 1e3
