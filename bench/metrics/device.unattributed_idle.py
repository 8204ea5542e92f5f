"""device.unattributed_idle: the share of the traced window that the device
sat idle while the host ran Python in no program span and no torch op, in
%.

The idle gaps `bench.trace` names "no host op recorded (Python)", over the
traced window."""
from bench import trace


def read(ctx):
    red = ctx.get("trace")
    if red is None or red["ops"] == 0 or red["window_s"] <= 0:
        return None
    sec = sum(s for name, s in red["gaps"] if name == trace.NO_HOST_OP)
    return 100.0 * sec / red["window_s"]
