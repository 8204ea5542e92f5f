"""k1.ms_per_step: K1's device time a launch, in ms (one launch a step)."""
from bench import trace


def read(ctx):
    red = ctx.get("trace")
    pattern = ctx.get("kernels", {}).get("k1")
    if red is None or pattern is None:
        return None
    k1_s, launches = trace.kernel_seconds(red, pattern)
    if launches == 0:
        return None
    return k1_s / launches * 1e3
