"""Serving launcher of the port: batched decode with slot-based continuous
batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
        [--smoke] [--requests 6] [--slots 4] [--max-seq 64] [--max-new 12] \\
        [--temperature 0.0] [--device cpu] [--metrics-dir DIR [--trace]]

Counterpart of `repro.launch.serve` (its decode path), with the reference's
flags and defaults.  The model is drawn from a seeded generator on the
device (no weights are downloaded); `--smoke` takes the reduced
same-family config.  Prompts of 4-8 random tokens come from
numpy.random.default_rng(0), as in the reference.  It runs on CUDA unless
`--device cpu` is given, and raises without a card.  Prints the summary
block of `obs.finish_run`, then a JSON summary (requests, tokens, wall s,
tok/s, slots, failed requests); `--metrics-dir DIR` writes the run's
`events.jsonl`, `metrics.prom` and `manifest.json` there (`--trace` adds
`trace.json`), as the reference's decode path does.

Not ported yet, and raising: `--fleet` (ROADMAP Queue 1 item 10), every
arch but rwkv6-3b (item 14).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.obs import add_obs_args, finish_run, telemetry_from_args


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--fleet", action="store_true",
                    help="serve a queue of online-RTRL training sessions "
                         "(not ported yet)")
    ap.add_argument("--update-every", type=int, default=8)
    ap.add_argument("--session-windows", type=int, default=12)
    add_obs_args(ap)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Serve `--requests` prompts; returns {"summary", "outputs",
    "failed_requests"}."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.runtime.serving import Engine, ServeConfig

    args = parse_args(argv)
    if args.fleet:
        raise NotImplementedError("--fleet (the online-RTRL stream fleet) is "
                                  "not ported yet: ROADMAP Queue 1 item 10")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    eng = Engine(cfg, ServeConfig(batch_slots=args.slots, max_seq=args.max_seq,
                                  temperature=args.temperature),
                 device=args.device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(4, 9)).tolist()
               for _ in range(args.requests)]
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=args.max_new)
    dt = time.perf_counter() - t0
    n_tok = sum(len(o) for o in outs)
    summary = {"arch": args.arch, "device": str(eng.device),
               "requests": len(prompts), "tokens": n_tok,
               "wall_s": round(dt, 3),
               "tok_per_s": round(n_tok / max(dt, 1e-9), 1),
               "slots": args.slots, "failed": len(eng.failed_requests)}
    obs = telemetry_from_args(args, mode="decode")
    finish_run(obs, f"serve {args.arch} (decode)", summary)
    print(json.dumps(summary))
    for i, o in enumerate(outs[:3]):
        print(f"  req{i}: {o}")
    return {"summary": summary, "outputs": outs,
            "failed_requests": sorted(eng.failed_requests)}


if __name__ == "__main__":
    main()
