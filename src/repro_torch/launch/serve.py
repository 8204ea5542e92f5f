"""Serving launcher of the port: batched decode with slot-based continuous
batching.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch gemma2-2b] \\
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

`--fleet` serves online-RTRL training sessions instead of decoding: a
queue of `--requests` independent EGRU streams drained through one
`runtime.fleet.StreamFleet` of `--slots` slots.  Sessions join free slots
mid-flight, train for `--session-windows` update windows of
`--update-every` stream steps each, and leave; admission is continuous.
The configuration is the reference's (`repro.launch.serve._fleet_main`):
an EGRU (kind gru) of n = 96 units, n_in 3, n_out 2, batch 8 a session,
parameter sparsity 0.9, backend `compact` with the column-compact carry,
adamw at 1e-3; `--smoke` cuts it to n = 16, batch 2, 3 windows, at most 6
sessions and 4 slots.  Masks come from torch.Generator(7) and params from
torch.Generator(0) (the reference's key numbers, not its `jax.random`
draws); session i's stream is the reference's numpy stream
(default_rng(i * 100003 + step)).  Prints the summary block, then a JSON
summary with the reference's fields.

    PYTHONPATH=src python -m repro_torch.launch.serve --fleet --smoke \
        --device cpu

Serving runs rwkv6-3b, the dense decoders (gemma2-2b, the default,
qwen3-8b, yi-6b, minitron-8b, internvl2-2b; the VLM decodes text tokens
only, as the reference's Engine does), the MoE decoders (olmoe-1b-7b,
kimi-k2-1t-a32b, whose 1.03 T parameters fit one card only at reduced
depth) and the RG-LRU LM (recurrentgemma-9b).  whisper-large-v3 (the
encoder-decoder) raises before anything is written (ROADMAP Queue 1 item
14).
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
                         "through one StreamFleet instead of decoding")
    ap.add_argument("--update-every", type=int, default=8,
                    help="--fleet: stream steps per update window")
    ap.add_argument("--session-windows", type=int, default=12,
                    help="--fleet: update windows per session")
    add_obs_args(ap)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    return ap.parse_args(argv)


def make_fleet_stream(seed: int, B: int, n_in: int, n_out: int):
    """Session `seed`'s step-keyed stream, the reference's numpy one."""
    def stream(step: int):
        rng = np.random.default_rng(seed * 100003 + step)
        x = rng.standard_normal((B, n_in)).astype(np.float32)
        y = (np.arange(B, dtype=np.int32) + seed) % n_out
        return x, y
    return stream


def fleet_setup(n: int, device, backend: str = "compact"):
    """The fleet's (cfg, masks, learner, opt, template params) at width n on
    `device`: the launcher runs backend `compact`; the card's smoke run
    drives the same configuration through K1 (`compact_fused`) and K2
    (`pallas`)."""
    from repro_torch.core import cells, sparse_rtrl as SP
    from repro_torch.core.cells import EGRUConfig
    from repro_torch.core.learner import LearnerSpec, make_learner
    from repro_torch.optim import make_optimizer

    cfg = EGRUConfig(n_hidden=n, n_in=3, n_out=2, kind="gru")
    masks = SP.make_masks(cfg, torch.Generator().manual_seed(7), 0.9,
                          device=device)
    learner = make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                       backend=backend, col_compact=True))
    opt = make_optimizer("adamw", lr=1e-3)
    params0 = SP.apply_masks(cells.init_params(
        cfg, torch.Generator().manual_seed(0), device=device), masks)
    return cfg, masks, learner, opt, params0


def fleet_main(args) -> dict:
    """Drain a queue of online-RTRL sessions through one StreamFleet.
    Returns {"summary", "completed" (the sids, in completion order)}."""
    from repro_torch.device import resolve_device
    from repro_torch.runtime.fleet import FleetConfig, StreamFleet

    # the reference's full run, or its --smoke cut
    fc = {"n": 16 if args.smoke else 96, "B": 2 if args.smoke else 8,
          "sessions": min(args.requests, 6) if args.smoke else args.requests,
          "slots": min(args.slots, 4) if args.smoke else args.slots,
          "windows": 3 if args.smoke else args.session_windows}
    device = resolve_device(args.device)
    cfg, masks, learner, opt, params0 = fleet_setup(fc["n"], device)
    stream_of = lambda i: make_fleet_stream(i, fc["B"], cfg.n_in, cfg.n_out)

    obs = telemetry_from_args(args, mode="fleet", slots=fc["slots"],
                              sessions=fc["sessions"])
    fleet = StreamFleet(FleetConfig(slots=fc["slots"],
                                    update_every=args.update_every),
                        learner, opt, params0, masks,
                        example=stream_of(0)(0), device=device,
                        telemetry=obs)
    queue = [(f"s{i}", stream_of(i)) for i in range(fc["sessions"])]
    need = {sid: fc["windows"] for sid, _ in queue}
    completed, fleet_windows = [], 0
    t0 = time.time()
    while len(completed) < fc["sessions"]:
        while queue and fleet.free_slots():        # continuous admission
            sid, stream = queue.pop(0)
            fleet.add_session(sid, stream)
        stats = fleet.step_window()
        fleet_windows += 1
        for sid in list(stats):
            need[sid] -= 1
            if need[sid] <= 0:                      # the session completes
                fleet.remove(sid)
                completed.append(sid)
    dt = time.time() - t0
    rep = fleet.report()
    summary = {"mode": "fleet", "sessions": fc["sessions"],
               "session_windows": fc["windows"], "slots": fc["slots"],
               "update_every": args.update_every,
               "fleet_windows": fleet_windows, "wall_s": round(dt, 3),
               "sessions_per_s": round(fc["sessions"] / max(dt, 1e-9), 2),
               "session_carry_bytes": rep["session_carry_bytes"]}
    for p in ("window_ms_p50", "window_ms_p99"):
        if p in rep:
            summary[p] = rep[p]
    finish_run(obs, "serve fleet (online RTRL)", summary)
    print(json.dumps(summary))
    return {"summary": summary, "completed": completed}


def main(argv=None) -> dict:
    """Serve `--requests` prompts; returns {"summary", "outputs",
    "failed_requests"} (with `--fleet`, `fleet_main`'s result)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.runtime.serving import Engine, ServeConfig

    args = parse_args(argv)
    if args.fleet:
        return fleet_main(args)
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
