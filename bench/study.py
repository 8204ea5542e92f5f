"""The readings the limits of a cell's check are set from: the program's
sound runs over many seeds, the control, and the planted faults.

    python3 bench/study.py --workload <name> --seeds 101,102,... \
        [--control-seeds 101,102,103] [--out FILE]

For each seed the system is built and warmed up as a run's set-up does,
its capture is held against the plain reference (the program's reading);
on the control seeds the reference itself is put in the program's place,
computed in TF32 (the control), and with each fault of the reference's
FAULTS planted (the fault readings).  One JSON line a reading, to standard
output and to `--out`.  The benchmark's runs never run this; it needs a
CUDA device unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seeds, control_seeds, device, cfg=None,
             emit=print):
    """Yield one reading dict per (seed, what)."""
    import torch
    from bench import generator, run as R
    from bench.systems import scaled_online as S
    bench = R.load_benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg = cfg if cfg is not None else R.load_config(cell["config"])
    mix = generator.load_mix(cell["traffic"])
    ref = S.load_reference(cfg["reference"])
    delta = cfg["check"]["v_margin"]
    for seed in seeds:
        t0 = time.perf_counter()
        system = S.build(cfg, mix, seed, device)
        xs, ys = system.reference_inputs()
        kb_prog = int(system.capture["idx"].ge(0).sum(dim=1).max())
        params0, masks, k = system.params0, system.masks, system.k
        capture = system.capture
        system.release()
        nums, diag = S.judge(ref, capture, params0, masks, xs, ys, cfg, k=k,
                             delta=delta)
        emit({"workload": workload, "seed": seed, "what": "program",
              "numbers": nums, **diag, "overflow": capture["overflow"],
              "kb_last_max": kb_prog, "seconds": time.perf_counter() - t0})
        del capture
        if seed not in control_seeds:
            continue
        for what, kw in [("control_tf32", {"precision": "tf32"})] + [
                (f"fault_{f}", {"fault": f}) for f in ref.FAULTS]:
            t0 = time.perf_counter()
            cap = S.stand_in_capture(ref, params0, masks, xs, ys, cfg, k,
                                     **kw)
            nums, diag = S.judge(ref, cap, params0, masks, xs, ys, cfg, k=k,
                                 delta=delta)
            emit({"workload": workload, "seed": seed, "what": what,
                  "numbers": nums, **diag,
                  "seconds": time.perf_counter() - t0})
            del cap
        if device != "cpu":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    try:
        readings(args.workload, seeds, control, args.device, emit=emit)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
