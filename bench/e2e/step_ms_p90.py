"""step_ms_p90: the 90th percentile of the time of every unit completed in
the measured window (an update window of an online learner, a decode step
of a server), in ms, by `statistics.quantiles(..., n=10)`."""
import statistics


def read(run):
    ms = [r["ms"] for r in run["records"]]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10)[8]
