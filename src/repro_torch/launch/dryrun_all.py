"""Run every (arch x cell) dry-run of the port as subprocesses
(counterpart of `repro.launch.dryrun_all`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--out DIR]
        [--only a,b] [--skip-existing] [--timeout S] [--jobs N]

One subprocess a cell (`launch.dryrun`), so one cell's failure does not
end the sweep; `--jobs` runs that many at once (the counts are
single-threaded Python; a full-size cell with a long plain-WKV loop takes
minutes).  Records land in `<out>/<arch>_<shape>_card.json`.  `--mesh`
takes `card` only: the reference's `single` / `multi` / `both` meshes wait
for the dry-run of the sharded steps on a fake process group, ROADMAP
item 17.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.configs import ARCHS, cells_for
from repro_torch.launch.dryrun import MESH_REFUSAL


def cell_cmd(arch, shape, out, skip_parts=False):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", "card", "--out", out]
    if skip_parts:
        cmd.append("--skip-parts")
    return cmd


def run_one(name, cmd, timeout):
    env = dict(os.environ)
    env["PYTHONPATH"] = env.get("PYTHONPATH", "src")
    t0 = time.time()
    try:
        p = subprocess.run(cmd, timeout=timeout, env=env,
                           capture_output=True, text=True)
        ok, tail = p.returncode == 0, (p.stdout[-1500:], p.stderr[-1500:])
    except subprocess.TimeoutExpired:
        ok, tail = False, ("", f"[timeout] {name}")
    return name, ok, time.time() - t0, tail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="card",
                    choices=["card", "single", "multi", "both"])
    ap.add_argument("--only", default="", help="comma-list of archs")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)
    if args.mesh != "card":
        print(MESH_REFUSAL.format(mesh=args.mesh, chips="256- and 512" if
                                  args.mesh == "both" else
                                  {"single": 256, "multi": 512}[args.mesh]),
              file=sys.stderr)
        return 2

    archs = args.only.split(",") if args.only else list(ARCHS)
    todo = []
    for arch in archs:
        for shape in cells_for(arch):
            name = f"{arch}_{shape}_card"
            path = Path(args.out) / f"{name}.json"
            if args.skip_existing and path.exists():
                if json.loads(path.read_text()).get("status") == "ok":
                    print(f"[skip] {name} (ok)")
                    continue
            todo.append((name, cell_cmd(arch, shape, args.out)))
    results = []
    with ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
        futs = [pool.submit(run_one, name, cmd, args.timeout)
                for name, cmd in todo]
        for f in futs:
            name, ok, dt, tail = f.result()
            if not ok:
                print(*tail)
            print(f"[{('OK' if ok else 'FAIL')}] {name} {dt:.0f}s", flush=True)
            results.append((name, ok, dt))

    n_ok = sum(1 for _, ok, _ in results if ok)
    print(f"\n=== dry-run sweep: {n_ok}/{len(results)} ok ===")
    for name, ok, dt in results:
        if not ok:
            print(f"  FAILED: {name}")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
