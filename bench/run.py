"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (`BENCHMARK.json`'s `workloads`)
names a configuration (`bench/configs/<config>.json`, whose `system` is a
module of `bench/systems/` and whose `reference` is its plain reference
beside it) and a traffic mix (`bench/traffic/<traffic>.json`).  Every
end-to-end metric is read by `bench/e2e/<name>.py`, every per-layer metric
by `bench/metrics/<name>.py`: a later cell, mix or metric is a file and an
entry, not an edit.

A run: set-up (the system draws its inputs from the seed, builds, and warms
up on the first units of work, which its check follows), then the measured
window of `--seconds`, then, with the program freed, the check against the
plain reference.  With `--trace 1` the first units of the window run under
`torch.profiler`, and the line carries the per-layer metrics, the device's
busy and traced seconds and a breakdown; the Chrome trace is written to
`build/bench-trace/<workload>.json` inside the checkout.

The last line of standard output is one JSON object; the numbers compared
are the last lines of standard error and the last key of that object.  No
result is printed, and the exit code is not 0, without enough CUDA
devices, without the program, or where a module of JAX or of the JAX
package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
CACHE = ROOT / "build" / "bench-cache"
TRACE_DIR = ROOT / "build" / "bench-trace"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CHUNK_S = 0.5            # units run between looks at the clock
TRACE_S = 2.0            # the traced stretch: at least this long ...
TRACE_UNITS = 4          # ... and at least this many units


class NoResult(Exception):
    """The run prints no result; the message says why."""

    def __init__(self, message: str, code: int = 2):
        super().__init__(message)
        self.code = code


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, each compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise NoResult(f"no {path}")
    return json.loads(path.read_text())


def load_config(name: str) -> dict:
    path = BENCH / "configs" / f"{name}.json"
    if not path.is_file():
        raise NoResult(f"no configuration {name!r} at {path}")
    cfg = json.loads(path.read_text())
    cfg.setdefault("name", name)
    return cfg


def reader(kind: str, name: str):
    """The `read` function of bench/<kind>/<name>.py."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise NoResult(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def e2e_of(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_of(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics read in this cell: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in e2e_of(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(torch, system, device, seconds: float, trace: bool,
            workload: str) -> dict:
    """The measured window: units of work through the system until
    `seconds` have passed, the first ones traced where asked."""
    _sync(torch, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    records, traced = [], None
    t0 = time.perf_counter()
    chunk = 1
    if trace:
        records += system.run_units(1)
        unit_s = records[-1]["ms"] / 1e3
        units = max(TRACE_UNITS, math.ceil(TRACE_S / max(unit_s, 1e-6)))
        traced = run_traced(torch, system, device, units, workload)
        records += traced.pop("records")
    while time.perf_counter() - t0 < seconds:
        recs = system.run_units(chunk)
        records += recs
        mean_s = sum(r["ms"] for r in recs) / len(recs) / 1e3
        chunk = max(1, int(CHUNK_S / max(mean_s, 1e-6)))
    elapsed = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    return {"records": records, "elapsed_s": elapsed, "peak_bytes": peak,
            "traced": traced}


def run_traced(torch, system, device, units: int, workload: str) -> dict:
    """`units` units under the profiler, inside the span the reduction
    reads; the Chrome trace to build/bench-trace/<workload>.json."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from bench import trace as T
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with system.traced() as tctx:
        with profile(activities=acts) as prof:
            _sync(torch, device)
            with record_function(T.SPAN):
                recs = system.run_units(units)
                _sync(torch, device)
    return {"records": recs, "prof": prof, "units": units, **tctx}


def reduce_trace(traced: dict, workload: str) -> dict:
    """The traced stretch reduced (`bench.trace`), once the window has
    closed; its Chrome trace to build/bench-trace/<workload>.json."""
    from bench import trace as T
    prof = traced.pop("prof")
    traced["reduced"] = T.reduce_events(T.profiler_events(prof))
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE_DIR / f"{workload}.json"))
    return traced


def run_cell(bench: dict, cell: dict, *, seed: int, seconds: float,
             trace: bool, device, t_start: float, cfg: dict | None = None,
             mix: dict | None = None) -> dict:
    """One run of `cell` on `device`: the result object and the checks."""
    import torch
    from bench import generator, trace as T
    device = torch.device(device)
    cfg = cfg if cfg is not None else load_config(cell["config"])
    mix = mix if mix is not None else generator.load_mix(cell["traffic"])
    system_mod = importlib.import_module(f"bench.systems.{cfg['system']}")
    t_build = time.perf_counter()
    system = system_mod.build(cfg, mix, seed, device)
    setup_s = time.perf_counter() - t_start - system.check_seconds
    run = measure(torch, system, device, seconds, trace, cell["name"])
    run["setup_s"] = setup_s
    metrics = {}
    if trace:
        tr = reduce_trace(run["traced"], cell["name"])
        ctx = {"trace": tr["reduced"], "units": tr["units"],
               "steps": tr["steps"], "kb": tr["kb"],
               "kb_prev": tr["kb_prev"], "shapes": system.shapes(),
               "counters": system.counters(),
               "kernels": cfg.get("kernels", {})}
        todo = per_layer_of(bench, cell["name"])
    else:
        ctx, todo = run, e2e_of(bench, cell["name"])
    for m in todo:
        value = reader("metrics" if trace else "e2e", m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = system.counters()
    info["setup_parts"] = {"start_s": t_build - t_start,
                           **system.setup_parts}
    ms = [r["ms"] for r in run["records"]]
    if ms:
        info["unit_ms"] = {"first": ms[0], "min": min(ms),
                           "median": statistics.median(ms), "max": max(ms),
                           "last": ms[-1]}
    device_rec = {"platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
                  "count": int(cell["chips"]),
                  "memory_peak_bytes": int(run["peak_bytes"])}
    out = {"attempted": len(run["records"]),
           "failed": sum(r["failed"] for r in run["records"]),
           "metrics": metrics, "device": device_rec}
    if trace:
        red = run["traced"]["reduced"]
        device_rec["busy_s"] = red["busy_s"]
        device_rec["window_s"] = red["window_s"]
        out["breakdown"] = T.breakdown(red)
    system.release()
    del run
    checks = system.check(cfg["check"]["limits"] | {
        "v_margin": cfg["check"]["v_margin"]}, cfg["reference"])
    info.update(getattr(system, "check_info", {}))
    correct = all(c["limit"] is None or c["value"] <= c["limit"]
                  for c in checks)
    out = {"correct": bool(correct), **out, "info": info,
           "checks": {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}}
    return out


def finite(x):
    """x with every non-finite float written as its name ("inf", "nan"),
    so that the line stays strict JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    try:
        bench = load_benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if args.workload not in cells:
            raise NoResult(f"no workload {args.workload!r} in BENCHMARK.json "
                           f"(has {sorted(cells)})")
        cell = cells[args.workload]
        sys.path[:0] = [str(ROOT), str(ROOT / "src")]
        import torch
        if not torch.cuda.is_available():
            raise NoResult("CUDA is not available: no result", 3)
        if torch.cuda.device_count() < int(cell["chips"]):
            raise NoResult(f"{cell['name']} needs {cell['chips']} CUDA "
                           f"devices, {torch.cuda.device_count()} present", 3)
        out = run_cell(bench, cell, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), device="cuda",
                       t_start=T_START)
        bad = forbidden_modules()
        if bad:
            raise NoResult(f"modules of JAX or of the JAX package are loaded: "
                           f"{bad}", 4)
    except NoResult as e:
        print(f"bench: {e}", file=sys.stderr)
        return e.code
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
