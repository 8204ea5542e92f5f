"""The port's dry-run of one cell on one card (counterpart of
`repro.launch.dryrun`): the cell's step built and counted on the meta
device, nothing allocated (`launch/dryrun_lib.py`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-3b \\
        --shape long_500k [--out DIR] [--skip-parts] [--tag T] [--set k=v ...]

The reference's flags.  `--mesh` takes `card` (the default: one card);
the reference's `single` and `multi` are its 256- and 512-chip TPU meshes,
and exit non-zero: the LM's sharded steps are ported (`launch.steps`'
builders take `mesh=`), but counting them on a fake process group of 256
or 512 ranks waits for ROADMAP item 17.
"""
from __future__ import annotations

import argparse
import sys

MESH_REFUSAL = ("--mesh {mesh}: the reference's {chips}-chip TPU mesh is not "
                "ported; the dry-run of the sharded steps on a fake process "
                "group waits for ROADMAP item 17 (this dry-run runs one "
                "card: --mesh card)")


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
    ap = argparse.ArgumentParser(description="One-card dry-run (meta device)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True,
                    choices=["train_4k", "prefill_32k", "decode_32k", "long_500k"])
    ap.add_argument("--mesh", default="card", choices=["card", "single", "multi"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-parts", action="store_true",
                    help="leave the per-part counts out of the record")
    ap.add_argument("--tag", default="", help="variant tag for perf iterations")
    ap.add_argument("--set", nargs="*", default=[],
                    help="cfg overrides key=value (int/float/str/bool)")
    args = ap.parse_args(argv)
    if args.mesh != "card":
        print(MESH_REFUSAL.format(mesh=args.mesh,
                                  chips={"single": 256, "multi": 512}[args.mesh]),
              file=sys.stderr)
        return 2

    from repro_torch.launch.dryrun_lib import run_cell
    rec = run_cell(args.arch, args.shape, args.out,
                   with_parts=not args.skip_parts,
                   cfg_overrides=parse_overrides(args.set) or None,
                   tag=args.tag)
    return 0 if rec["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
