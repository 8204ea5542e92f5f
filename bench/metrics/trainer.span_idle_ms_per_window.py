"""trainer.span_idle_ms_per_window: device idle time a window while the
host runs the trainer's own Python, in ms.

The idle gaps named `window` or `trainer.*` (the gather, the readback, the
bookkeeping between windows, and the window's code outside any phase),
over the traced windows."""
from bench import span_gaps


def read(ctx):
    units = ctx.get("units", 0)
    sec = span_gaps.idle_seconds(
        ctx.get("trace"),
        lambda name: name == "window" or name.startswith("trainer."))
    if sec is None or units <= 0:
        return None
    return sec / units * 1e3
