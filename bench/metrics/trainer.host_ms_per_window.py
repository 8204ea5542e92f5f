"""trainer.host_ms_per_window: the trainer's host time a window, in ms.

A traced window's wall time less the device busy time inside it, averaged
over the traced windows: what the host adds to a window (the stream's rows,
their stacking and copy, the Python of the trainer, the learner and the
optimizer, the launches, the readback) where the device does not cover it."""


def read(ctx):
    red, units = ctx.get("trace"), ctx.get("units", 0)
    if red is None or units <= 0:
        return None
    return (red["window_s"] - red["busy_s"]) / units * 1e3
