"""The port's dry-run of one cell (counterpart of `repro.launch.dryrun`):
the cell's step built and counted on the meta device, nothing allocated
(`launch/dryrun_lib.py`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-3b \\
        --shape long_500k [--mesh card|single|multi] [--out DIR] \\
        [--skip-parts] [--tag T] [--smoke] [--set k=v ...]

The reference's flags, and `--smoke` (the arch's reduced config at the
shape's batch and length).  `--mesh card` (the default) counts the step
on one card; `single` and `multi` count one rank (rank 0) of the sharded
step on the reference's 16 x 16 and 2 x 16 x 16 meshes, built over a
one-process fake process group of 256 or 512 ranks, with the collectives
the rank issues and their bytes.
"""
from __future__ import annotations

import argparse
import sys


def parse_overrides(pairs) -> dict:
    """key=value pairs -> {key: int, float, bool or str}, as the
    reference's `--set` casts them."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "True"):
            v = True
        if v in ("false", "False"):
            v = False
        overrides[k] = v
    return overrides


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Dry-run of one cell on one "
                                 "card or one mesh rank (meta device)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True,
                    choices=["train_4k", "prefill_32k", "decode_32k", "long_500k"])
    ap.add_argument("--mesh", default="card", choices=["card", "single", "multi"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-parts", action="store_true",
                    help="leave the per-part counts out of the record")
    ap.add_argument("--tag", default="", help="variant tag for perf iterations")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (a test's size)")
    ap.add_argument("--set", nargs="*", default=[],
                    help="cfg overrides key=value (int/float/str/bool)")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun_lib import run_cell
    rec = run_cell(args.arch, args.shape, args.out,
                   with_parts=not args.skip_parts,
                   cfg_overrides=parse_overrides(args.set) or None,
                   tag=args.tag, smoke=args.smoke, mesh=args.mesh)
    return 0 if rec["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
