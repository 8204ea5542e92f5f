"""trainer.gather_idle_ms_per_window: device idle time a window while the
host gathers the window's inputs, in ms.

The idle gaps named `trainer.gather` (`OnlineTrainer._gather`: the stream's
rows, their stack and the copy to the card), over the traced windows: the
part of `trainer.host_ms_per_window` that reading the next window's inputs
ahead would hide."""
from bench import span_gaps


def read(ctx):
    units = ctx.get("units", 0)
    sec = span_gaps.idle_seconds(ctx.get("trace"),
                                 lambda name: name == "trainer.gather")
    if sec is None or units <= 0:
        return None
    return sec / units * 1e3
