"""Online training launcher of the port: the paper's spiral experiment.

    PYTHONPATH=src python -m repro_torch.launch.train --arch egru-spiral \\
        --online [--rtrl-backend {dense,pallas,compact,compact_fused}] \\
        --sparsity 0.8 [--col-compact {auto,on,off}] \\
        [--update-every 8] [--steps 20] [--seed 0] [--capacity 1.0] \\
        [--influence-dtype float32] [--smoke] [--device cpu]

Counterpart of `repro.launch.train` (`train_egru` -> `train_egru_online`):
a one-layer EGRU (n=16, n_in=2, batch 32) trained by exact sparse RTRL on
the spiral stream, with a masked adamw update every `--update-every` stream
steps.  `--steps` counts optimizer updates; `--smoke` caps them at 12.  The
backend defaults to "dense", as in the reference.  It runs on CUDA unless
`--device cpu` is given, and raises without a card.

Params are drawn from torch.Generator(2*seed) and masks from
torch.Generator(2*seed + 1): a seed reproduces a run on every device, but
not the JAX package's `jax.random` draws.  The stream is the JAX launcher's
step-keyed numpy stream, element for element.

Flags of later slices raise: --layers > 1, --guard, --rewire, --metrics-dir,
--ckpt-every, --fail-at.
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from repro_torch.device import resolve_device

ARCHS = ("egru-spiral", "egru_spiral")


def make_stream(cfg, seed: int):
    """The JAX launcher's stream (`repro.launch.train.train_egru_online`):
    one spiral sequence per T steps, batch drawn from a step-keyed rng."""
    from repro_torch.data.spiral import spiral_dataset
    T = cfg.seq_len
    xs_all, ys_all = spiral_dataset(T=T, seed=0)

    def stream(step):
        s, t = divmod(step, T)
        rng = np.random.default_rng(1234 + seed * 100003 + s)
        sel = rng.integers(0, ys_all.shape[0], size=cfg.batch_size)
        return xs_all[sel][:, t], ys_all[sel]

    return stream


def _reject_later_slices(args) -> None:
    later = []
    if args.arch not in ARCHS:
        later.append(f"--arch {args.arch} (the port has egru-spiral only)")
    if not args.online:
        later.append("offline sequence training (pass --online; the offline "
                     "Trainer is ROADMAP Queue 1 item 4)")
    if args.layers != 1:
        later.append("--layers > 1 (stacked engine, ROADMAP Queue 1 item 7)")
    if args.guard:
        later.append("--guard (ROADMAP Queue 1 item 9)")
    if args.rewire != "off":
        later.append("--rewire (ROADMAP Queue 1 item 8)")
    if args.metrics_dir:
        later.append("--metrics-dir (ROADMAP Queue 1 item 11)")
    if args.ckpt_every:
        later.append("--ckpt-every (ROADMAP Queue 1 item 4)")
    if args.fail_at >= 0:
        later.append("--fail-at (ROADMAP Queue 1 item 4)")
    if later:
        raise SystemExit("not ported yet: " + "; ".join(later))


def build_online(args) -> dict:
    """Everything the online run needs, on the resolved device: cfg, masks,
    params (masked), opt, learner, stream, device."""
    from repro_torch.configs import egru_spiral
    from repro_torch.core import cells, stacked_rtrl as ST
    from repro_torch.core.learner import LearnerSpec, make_learner
    from repro_torch.optim.optimizers import make_optimizer, masked

    _reject_later_slices(args)
    backend = args.rtrl_backend
    # resolve the auto rule once and hand the engine the explicit bool, so
    # the report below cannot disagree with what the engine runs
    col_flag = {"auto": None, "on": True, "off": False}[args.col_compact]
    if backend == "compact_fused" and col_flag is False:
        raise SystemExit("--col-compact off conflicts with --rtrl-backend "
                         "compact_fused (the fused engine always carries "
                         "column-compact)")
    device = resolve_device(args.device)
    cfg = egru_spiral.stacked(args.layers)
    masks = None
    if args.sparsity > 0.0:
        masks = ST.make_stacked_masks(
            cfg, torch.Generator().manual_seed(2 * args.seed + 1),
            args.sparsity, device=device)
    if backend == "compact_fused":
        col_compact = True
    else:
        col_compact = (masks is not None and backend != "dense"
                       if col_flag is None else col_flag)
    params = cells.init_stacked_params(
        cfg, torch.Generator().manual_seed(2 * args.seed), device=device)
    opt = make_optimizer("adamw", lr=cfg.lr)
    if masks is not None:
        params = ST.apply_stacked_masks(params, masks)
        opt = masked(opt, {"layers": masks, "out": None})
    if masks is not None and backend != "dense":
        slayout = ST.stacked_layout(cfg)
        live = int(ST.stacked_col_mask(slayout, masks, device="cpu").sum())
        print(f"influence columns: {live}/{slayout.P_total} live "
              f"(omega~={ST.stacked_omega_tilde(masks):.3f}); col-compact "
              f"carry {'ON' if col_compact else 'OFF'}")
    learner = make_learner(LearnerSpec(
        engine="stacked", cfg=cfg, backend=backend, capacity=args.capacity,
        col_compact=col_compact, influence_dtype=args.influence_dtype))
    return {"cfg": cfg, "masks": masks, "params": params, "opt": opt,
            "learner": learner, "stream": make_stream(cfg, args.seed),
            "device": device}


def train_egru_online(args) -> dict:
    """True ONLINE training on the spiral stream; `--steps` counts optimizer
    updates.  Returns the trainer's result plus the printed summary."""
    from repro_torch.runtime.online import OnlineTrainer, OnlineTrainerConfig
    run = build_online(args)
    updates = min(args.steps, 12) if args.smoke else args.steps
    k = args.update_every
    ocfg = OnlineTrainerConfig(total_steps=updates * k, update_every=k)
    trainer = OnlineTrainer(ocfg, run["learner"], run["opt"], run["params"],
                            run["masks"], run["stream"],
                            device=run["device"])
    out = trainer.run()
    with_loss = [m for m in out["metrics"] if "loss" in m]
    summary = {"arch": "egru-spiral", "mode": "online", "layers": args.layers,
               "backend": args.rtrl_backend, "device": str(run["device"]),
               "update_every": k, "updates": out["updates"],
               "final_step": out["final_step"],
               "carry_bytes": out["carry_bytes"],
               "first_loss": with_loss[0]["loss"],
               "final_loss": with_loss[-1]["loss"],
               "act_sparsity": with_loss[-1].get("alpha"),
               "bwd_sparsity": with_loss[-1].get("beta"),
               "overflow": max(w.get("overflow", 0.0)
                               for w in out["windows"]),
               "median_window_ms": statistics.median(
                   w["ms"] for w in out["windows"])}
    print(json.dumps(summary))
    out["summary"] = summary
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="egru-spiral")
    ap.add_argument("--online", action="store_true",
                    help="streaming training: an optimizer update every "
                         "--update-every stream steps (--steps counts "
                         "updates)")
    ap.add_argument("--rtrl-backend", default="dense",
                    choices=["dense", "pallas", "compact", "compact_fused"])
    ap.add_argument("--sparsity", type=float, default=0.0,
                    help="fixed parameter sparsity of the recurrent weights")
    ap.add_argument("--col-compact", choices=["auto", "on", "off"],
                    default="auto",
                    help="carry the influence parameter axis column-compact "
                         "(auto: on whenever --sparsity > 0 and the backend "
                         "is not 'dense')")
    ap.add_argument("--update-every", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--influence-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--capacity", type=float, default=1.0,
                    help="compact row capacity fraction")
    ap.add_argument("--smoke", action="store_true",
                    help="cap the run at 12 updates")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    # flags of later slices: accepted so that they fail with a clear error
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--guard", action="store_true")
    ap.add_argument("--rewire", default="off")
    ap.add_argument("--metrics-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=-1)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    return train_egru_online(parse_args(argv))


if __name__ == "__main__":
    main()
