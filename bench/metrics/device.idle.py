"""device.idle: the share of the traced window with no device operation
running, in %."""


def read(ctx):
    red = ctx.get("trace")
    if red is None or red["window_s"] <= 0 or red["ops"] == 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
