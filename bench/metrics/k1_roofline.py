"""k1_roofline: K1's share of its roofline, in %.

The sum over the traced launches of each launch's least time, over K1's
summed device time.  A launch's least time is the larger of its operations
over the compute peak and its bytes over HBM bandwidth, each at the row
counts K_b, K'_b that launch had (`bench.costs`)."""
from bench import costs, trace


def read(ctx):
    red = ctx.get("trace")
    pattern = ctx.get("kernels", {}).get("k1")
    shp = ctx.get("shapes")
    kb, kb_prev = ctx.get("kb", []), ctx.get("kb_prev", [])
    if red is None or pattern is None or shp is None or not kb:
        return None
    k1_s, launches = trace.kernel_seconds(red, pattern)
    if launches == 0 or launches != len(kb):
        return None
    least = 0.0
    for now, prev in zip(kb, kb_prev):
        flops = costs.k1_flops(now, prev, shp["Pc_pad"])
        nbytes = costs.k1_bytes(now, prev, shp["Pc_pad"], shp["capacity"],
                                shp["carry_dtype_bytes"])
        least += costs.least_seconds(flops, nbytes)[0]
    return 100.0 * least / k1_s
