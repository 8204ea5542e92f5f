"""engine.nonk1_ms_per_step: device busy time a stream step outside K1, ms.

The traced window's device busy time less K1's kernel time, over its stream
steps: the cell's partials, the row compaction, the M-bar rows, the J-hat
pass, the gradient extraction and, once a window, the masked adamw update
and the readback."""
from bench import trace


def read(ctx):
    red, steps = ctx.get("trace"), ctx.get("steps", 0)
    pattern = ctx.get("kernels", {}).get("k1")
    if red is None or steps <= 0 or pattern is None:
        return None
    k1_s, launches = trace.kernel_seconds(red, pattern)
    if launches == 0:
        return None
    return (red["busy_s"] - k1_s) / steps * 1e3
