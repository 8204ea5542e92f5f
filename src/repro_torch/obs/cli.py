"""Launcher glue: argparse flags + run finishing for the telemetry plane.

Counterpart of `repro.obs.cli`.

Every entry point (`launch/train.py`, `launch/serve.py`) wires telemetry
the same three-line way:

    add_obs_args(ap)                       # --metrics-dir / --trace
    obs = telemetry_from_args(args, arch=...)   # null when flags are off
    ... run, passing telemetry=obs ...
    finish_run(obs, "title", result, skip=("metrics",))

`finish_run` is the ONE summary path (the three divergent printer blocks
train/serve/fleet used to carry): it lands the result's scalar fields on
the registry as gauges, prints the unified `format_summary` block, and
finalizes the exporters (metrics.prom / manifest.json / trace.json) when
`--metrics-dir` is set.
"""
from __future__ import annotations

from repro_torch.obs.summary import print_summary
from repro_torch.obs.telemetry import Telemetry


def add_obs_args(ap):
    ap.add_argument("--metrics-dir", default=None,
                    help="telemetry export directory: per-window JSONL "
                         "events, Prometheus text exposition, run manifest "
                         "(repro_torch.obs; validate with "
                         "`python -m repro_torch.obs.validate <dir>`)")
    ap.add_argument("--trace", action="store_true",
                    help="record spans (window / rewire / rollback_replay / "
                         "ckpt_write and the window's phases, trainer.* / "
                         "engine.* / k1.launch) and export Chrome-trace "
                         "JSON to <metrics-dir>/trace.json — load in "
                         "chrome://tracing; stamped on torch.profiler's "
                         "clock, whose traces show each span as a host "
                         "range")
    return ap


def telemetry_from_args(args, **config) -> Telemetry:
    """Active telemetry when --metrics-dir is set, else the null form.
    `config` keys land in the run manifest alongside the CLI args."""
    if not getattr(args, "metrics_dir", None):
        return Telemetry.null()
    cfg = {k: v for k, v in vars(args).items()
           if isinstance(v, (str, int, float, bool)) or v is None}
    cfg.update(config)
    return Telemetry.create(args.metrics_dir,
                            trace=getattr(args, "trace", False), config=cfg)


def finish_run(obs: Telemetry, title: str, result: dict,
               skip: tuple = ()) -> dict:
    """The one summary/finalize path for every launcher: mirror the
    result's scalar fields onto the registry, print the unified summary
    block, write the export artifacts.  Returns `result` unchanged."""
    final = {}
    for k, v in result.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        obs.registry.gauge(k).set(v)
        final[k] = v
    print_summary(title, result, skip=skip)
    obs.finalize(final=final)
    return result
