"""engine.ops_per_step: device operations a stream step.

Kernels, copies and sets the profiler recorded on the device in the traced
window, over its stream steps (a window's update and readback included)."""


def read(ctx):
    red, steps = ctx.get("trace"), ctx.get("steps", 0)
    if red is None or steps <= 0 or red["ops"] == 0:
        return None
    return red["ops"] / steps
