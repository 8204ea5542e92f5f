"""device.window_mfu: the whole window's share of the card's compute peak,
in %.

The operations the exact algorithm needs for the traced windows, at the row
counts each step had (K1's update, the cell's forward, the readout and the
gradient extraction, `bench.costs`), over the traced wall time and the
peak.  It bounds a gain whatever implements the step."""
from bench import costs


def read(ctx):
    red, shp = ctx.get("trace"), ctx.get("shapes")
    kb, kb_prev = ctx.get("kb", []), ctx.get("kb_prev", [])
    if red is None or shp is None or not kb or red["window_s"] <= 0:
        return None
    ops = 0.0
    for now, prev in zip(kb, kb_prev):
        ops += costs.k1_flops(now, prev, shp["Pc_pad"])
        ops += costs.rnn_step_flops(shp["batch"], shp["n"], shp["n_in"],
                                    shp["n_out"], now, shp["Pc_pad"])
    return 100.0 * ops / (red["window_s"] * costs.PEAK_FLOP_S)
