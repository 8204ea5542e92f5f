"""Training launcher of the port: the paper's spiral experiment, the
online token LM and the LM families.

    PYTHONPATH=src python -m repro_torch.launch.train --arch egru-spiral \\
        [--online] [--rtrl-backend {dense,pallas,compact,compact_fused}] \\
        --sparsity 0.8 [--col-compact {auto,on,off}] \\
        [--update-every 8] [--steps 20] [--seed 0] [--capacity 1.0] \\
        [--influence-dtype float32] [--layers 1] [--smoke] [--device cpu] \\
        [--ckpt-every 10] [--ckpt-dir DIR] [--fail-at K] [--metrics FILE] \\
        [--rewire {off,set,rigl} --rewire-every N --rewire-frac F] \\
        [--guard --guard-ring R --guard-policy P] \\
        [--inject-nan-at S --inject-nan-len N --inject-corrupt-at U] \\
        [--metrics-dir DIR [--trace]]

Counterpart of `repro.launch.train` (`train_egru`): an EGRU (n=16 a layer,
n_in=2, batch 32; `--layers L` stacks L layers, `configs.egru_spiral.
stacked(L)`) trained by exact sparse RTRL on the spiral task with a masked
adamw update, through the checkpoint/restart supervisor
(`runtime.trainer.run_with_restart`).  One layer runs the single-layer
engine; L >= 2 the block lower-triangular stacked engine
(`core.stacked_rtrl`), one K1 (`compact_fused`) or K2 (`pallas`) launch a
layer a stream step.

  * `--online`: the spiral stream, an update every `--update-every` stream
    steps, mid-sequence (`runtime.online.OnlineTrainer`); `--steps` counts
    optimizer updates and `--smoke` caps them at 12.  Checkpoints hold the
    learner carry, so a restart resumes mid-stream.
  * `--online --rewire {set,rigl}`: dynamic sparsity — every
    `--rewire-every` updates each recurrent W/R tensor prunes and regrows
    a cosine-decayed fraction (from `--rewire-frac`) of its live weights,
    with exact carry migration (`sparsity`; the optimizer mask lives in
    its state, `optim.optimizers.masked_dynamic`).  Refused offline, at
    `--sparsity 0` and with `compact_fused`, as in the reference.  SET
    draws its scores from `--seed` and the event index (a torch.Generator
    per tensor), not from `jax.random`.
  * `--online --guard`: the stream guard (`runtime.guard`): health checks
    every window, a ring of `--guard-ring` snapshots, rollback and replay
    under `--guard-policy`.  `--inject-nan-at S --inject-nan-len N` feeds
    NaN inputs at stream steps [S, S+N) (on every attempt);
    `--inject-corrupt-at U` poisons one influence element after update U
    (on the first attempt only).
  * otherwise, offline: one whole 17-step sequence per optimizer step
    (`core.stacked_rtrl.stacked_rtrl_loss_and_grads`,
    `runtime.trainer.Trainer`); `--steps` counts steps.  The batch of step s
    is drawn from np.random.default_rng(1234 + s), whatever `--seed`, as
    in the reference.  Backend `compact_fused` runs here too (the port
    builds eagerly; the reference's traced offline path cannot build its
    gate segments).

`--ckpt-every N` checkpoints every N updates (online) or steps (offline)
into `--ckpt-dir` (default `<tempdir>/repro_torch_ckpt`, the port's own:
never the JAX launcher's /tmp/repro_ckpt); 0 turns the periodic
checkpoints off (offline still writes the final one).  A run resumes from
the newest valid checkpoint in its directory, so a rerun into the same
directory resumes at its end.  `--fail-at K` injects one crash at update
(online) or step (offline) K, and the supervisor restarts from the last
checkpoint.  `--metrics FILE` appends the logged records as JSON lines.

`--metrics-dir DIR` turns the telemetry plane on (`repro_torch.obs`): the
online trainer packs every window's scalars (loss, gradient norm,
activity and backward sparsity, overflow, live column fraction, K_b,
clip factor, health) into one tensor, read back once a window, and DIR
receives `events.jsonl` (a `window` event per update, `rewire`, `fault`,
`rollback`, `recovery`, `quarantine` and `ckpt_write` events),
`metrics.prom` and `manifest.json`; `--trace` adds `trace.json` (Chrome
trace of the window / rewire / rollback_replay / ckpt_write spans, each
also a `torch.profiler.record_function`).  Check DIR with `python -m
repro_torch.obs.validate DIR`.  A run with telemetry is bitwise the run
without it.  Both paths end with the summary block of
`obs.finish_run`, then the JSON summary line.

The backend defaults to "dense", as in the reference.  It runs on CUDA
unless `--device cpu` is given, and raises without a card.  Params are
drawn from torch.Generator(2*seed) and masks from torch.Generator(2*seed +
1): a seed reproduces a run on every device, but not the JAX package's
`jax.random` draws.  The online stream is the JAX launcher's step-keyed
numpy stream, element for element.

The online token LM (counterpart of the reference's `train_lm_online`):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch {egru-lm,rglru-lm,snn-lm} --online [--vocab 64] [--width 64] \\
        [--lr 3e-3] [--batch 4] [--seq 64] [--sparsity S] [--smoke] \\
        [--rtrl-backend B --capacity C (egru-lm)] [--device cpu] [...]

trains a next-token head online, one token a stream step
(`data.tokens.token_lm_stream`, seed 1234 + --seed), with the engine
matched to the cell: egru-lm -> 'sparse' (the EGRU influence carry, every
backend: K1 with compact_fused, K2 with pallas), rglru-lm -> 'diag_exact'
(exact diagonal traces, `cells.rglru`), snn-lm -> 'eprop' (spiking
eligibility traces, `cells.snn`).  `--online` is required and `--steps`
counts updates; `--smoke` runs vocab 16, width <= 32 and <= 10 updates.
`--sparsity` masks the EGRU's W/R or the rgLRU's Wx/Wi/Wa (lam dense) and
is refused for snn-lm.  The run goes through the same OnlineTrainer,
checkpoints, `--fail-at` and telemetry as the spiral stream.  The
reference's LM path silently ignores the flags it does not read
(`--layers`, `--rewire*`, `--guard*`, `--inject-*`, `--influence-dtype`,
`--col-compact`, and `--rtrl-backend` / `--capacity` off egru-lm); the port
refuses each of them, when not at its default, before anything is
written, and likewise refuses the LM's own flags beside egru-spiral.

The LM families (counterpart of the reference's LM path, its `main`):

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch {gemma2-2b,qwen3-8b,yi-6b,minitron-8b,internvl2-2b,rwkv6-3b,
                olmoe-1b-7b,kimi-k2-1t-a32b,recurrentgemma-9b,
                whisper-large-v3} \
        [--smoke] [--steps 20] [--batch 4] [--seq 64] [--seed 0] \
        [--device cpu] [--ckpt-every 10] [--ckpt-dir DIR] [--fail-at K] \
        [--metrics FILE] [--metrics-dir DIR [--trace]] [--production-mesh]

trains offline through `launch.steps.make_train_step` (the loss over
cfg.n_microbatches slices, the global norm clipped to 1.0, the config's
optimizer at lr 3e-4: lion for kimi-k2, adamw otherwise) and the same
Trainer, checkpoints and restart supervisor.  `--smoke` takes the reduced same-family config.  The batch of
step s is `data.tokens.synthetic_token_batches(batch, seq, vocab, seed=1234
+ s)` (with internvl2's patch embeddings, and whisper's [enc_seq,
d_model] frames), so a restart replays it; the parameters are drawn from
torch.Generator(--seed) on the device.  RWKV6 trains through the plain WKV
(`models.rwkv.loss_fn`); a MoE decoder's loss adds 0.01 x its
load-balance loss.  The flags this path does not read (the spiral's and
the online LM's) are refused before anything is written.

Under a process group (`torchrun --nproc-per-node N -m
repro_torch.launch.train ...`, or `launch.mesh.spawn`) every LM arch
trains over `make_host_mesh()` (N x 1) across its ranks, as the reference
does, through the step's mesh form (FSDP or pure data parallelism as the
rules and the config pick; the MoE decoders' expert parallelism over
'model'); `--production-mesh` takes `make_production_mesh()` (16 x 16),
which needs 256 ranks and raises on another world size.  The parameters
are drawn whole and each rank keeps its shards; checkpoints are written
shard by shard and restore onto the run's own mesh
(`Trainer(shardings=...)`); rank 0 prints the summary.  An optimizer
whose state is not elementwise (adafactor) is refused over a mesh before
anything is written (ROADMAP item 17).
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import add_obs_args, finish_run, telemetry_from_args

ARCHS = ("egru-spiral", "egru_spiral")
LM_ARCHS = {"egru-lm": "sparse", "rglru-lm": "diag_exact", "snn-lm": "eprop"}

# flags (argparse dest -> default) that a path does not read: given at
# another value beside its arch they are refused, not ignored
_LM_FLAGS = {"vocab": 64, "width": 64, "lr": 3e-3, "batch": 4, "seq": 64}
_SPIRAL_FLAGS = {"layers": 1, "rewire": "off", "rewire_every": 50,
                 "rewire_frac": 0.3, "guard": False, "guard_ring": 4,
                 "guard_policy": "full", "inject_nan_at": -1,
                 "inject_nan_len": 1, "inject_corrupt_at": -1,
                 "influence_dtype": "float32", "col_compact": "auto"}
_EGRU_FLAGS = {"rtrl_backend": "dense", "capacity": 1.0}


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


def make_offline_data(cfg):
    """The JAX launcher's offline batches (`train_egru`'s `data_at`): step
    -> (xs [T, B, n_in], labels [B]) as numpy, from default_rng(1234 +
    step)."""
    from repro_torch.data.spiral import spiral_dataset
    xs_all, ys_all = spiral_dataset(T=cfg.seq_len, seed=0)

    def data_at(step):
        rng = np.random.default_rng(1234 + step)
        sel = rng.integers(0, ys_all.shape[0], size=cfg.batch_size)
        return np.swapaxes(xs_all[sel], 0, 1), ys_all[sel]

    return data_at


def _loss_fields(metrics: list) -> dict:
    """first/final loss (+ sparsity) from the trainer's metric records; {}
    when the run executed nothing (it resumed at its end)."""
    with_loss = [m for m in metrics if "loss" in m]
    if not with_loss:
        return {}
    first, last = with_loss[0], with_loss[-1]
    out = {"first_loss": first["loss"], "final_loss": last["loss"]}
    if "alpha" in last:
        out["act_sparsity"] = last["alpha"]
    if "beta" in last:
        out["bwd_sparsity"] = last["beta"]
    return out


def _median_ms(records: list) -> float | None:
    return statistics.median(r["ms"] for r in records) if records else None


def _refuse_unread(args, unread: dict) -> None:
    """SystemExit naming every flag of `unread` given at another value
    than its default: the arch's path does not read it."""
    given = [f"--{k.replace('_', '-')}" for k, default in unread.items()
             if getattr(args, k) != default]
    if given:
        raise SystemExit(f"{', '.join(given)}: not read by --arch "
                         f"{args.arch}, so refused rather than ignored")


def _build_common(args) -> dict:
    """What both paths need, on the resolved device: cfg, masks, a params
    factory (masked), opt, the explicit col_compact flag and the device.
    Every refusal comes before anything is written."""
    from repro_torch.configs import egru_spiral
    from repro_torch.core import cells, stacked_rtrl as ST
    from repro_torch.optim.optimizers import (make_optimizer, masked,
                                              masked_dynamic)

    _refuse_unread(args, {**_LM_FLAGS, "production_mesh": False})
    backend = args.rtrl_backend
    rewiring = args.rewire != "off"
    if rewiring and not args.online:
        raise SystemExit("--rewire needs --online (events fire at online "
                         "update boundaries)")
    if rewiring and args.sparsity <= 0.0:
        raise SystemExit("--rewire needs --sparsity > 0 (there is no mask "
                         "to evolve at density 1)")
    if rewiring and backend == "compact_fused":
        raise SystemExit("--rewire is not supported with the compact_fused "
                         "backend (its gate-segment table is compiled from "
                         "the init-time masks) — use --rtrl-backend compact")
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

    def make_params():
        params = cells.init_stacked_params(
            cfg, torch.Generator().manual_seed(2 * args.seed), device=device)
        return params if masks is None else ST.apply_stacked_masks(params,
                                                                   masks)

    opt = make_optimizer("adamw", lr=cfg.lr)
    if masks is not None:
        # rewiring swaps masks at run time: the mask then lives in the
        # optimizer state
        opt = (masked_dynamic if rewiring else masked)(
            opt, {"layers": masks, "out": None})
    if masks is not None and backend != "dense":
        slayout = ST.stacked_layout(cfg)
        colm = ST.stacked_col_mask(slayout, masks, device="cpu")
        per_layer = ""
        if cfg.n_layers > 1:
            per_layer = " (" + " + ".join(
                str(int(colm[slayout.layer_slice(l)].sum()))
                for l in range(cfg.n_layers)) + " by layer)"
        print(f"influence columns: {int(colm.sum())}/{slayout.P_total} live"
              f"{per_layer} (omega~={ST.stacked_omega_tilde(masks):.3f}); "
              f"col-compact carry {'ON' if col_compact else 'OFF'}")
    return {"cfg": cfg, "masks": masks, "make_params": make_params,
            "params": make_params(), "opt": opt, "col_compact": col_compact,
            "device": device,
            "updates": min(args.steps, 12) if args.smoke else args.steps}


def build_online(args) -> dict:
    """Everything the online run needs, on the resolved device: cfg, masks,
    params (masked) and their factory, opt, learner, stream, device."""
    from repro_torch.core.learner import LearnerSpec, make_learner
    run = _build_common(args)
    run["learner"] = make_learner(LearnerSpec(
        engine="stacked", cfg=run["cfg"], backend=args.rtrl_backend,
        capacity=args.capacity, col_compact=run["col_compact"],
        influence_dtype=args.influence_dtype,
        rewirable=args.rewire != "off"))
    run["stream"] = make_stream(run["cfg"], args.seed)
    return run


def online_trainers(args, run, telemetry=None):
    """make_trainer(attempt) for `run_with_restart`: an OnlineTrainer on
    the run's learner with fresh params, the rewire schedule, the guard,
    the fault plan of the flags and `telemetry` (shared by every attempt);
    `--fail-at` and `--inject-corrupt-at` armed on attempt 0 only (NaN
    inputs stay armed: a data fault lives in the stream)."""
    from repro_torch.runtime.guard import FaultPlan, GuardConfig
    from repro_torch.runtime.online import OnlineTrainer, OnlineTrainerConfig
    from repro_torch.sparsity import RewireSchedule
    updates = run["updates"]
    k = args.update_every
    schedule = None
    if args.rewire != "off":
        schedule = RewireSchedule(
            method=args.rewire, every_k=args.rewire_every,
            frac=args.rewire_frac,
            t_end=max(1, updates // args.rewire_every))
    guard = GuardConfig(ring=args.guard_ring, policy=args.guard_policy) \
        if args.guard else None

    def make_trainer(attempt=0):
        ocfg = OnlineTrainerConfig(
            total_steps=updates * k, update_every=k,
            ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
            fail_at_update=args.fail_at if attempt == 0 else -1,
            metrics_path=args.metrics, seed=args.seed)
        plan = None
        if args.inject_nan_at >= 0 or args.inject_corrupt_at >= 0:
            plan = FaultPlan(nan_input_at=args.inject_nan_at,
                             nan_input_len=args.inject_nan_len,
                             corrupt_carry_at_update=(
                                 args.inject_corrupt_at if attempt == 0
                                 else -1))
        return OnlineTrainer(ocfg, run["learner"], run["opt"],
                             run["make_params"](), run["masks"],
                             run["stream"], device=run["device"],
                             rewire_schedule=schedule, guard=guard,
                             fault_plan=plan, telemetry=telemetry)

    return make_trainer


def train_egru_online(args) -> dict:
    """True ONLINE training on the spiral stream; `--steps` counts optimizer
    updates.  Returns the trainer's result plus the printed summary."""
    from repro_torch.runtime.trainer import run_with_restart
    run = build_online(args)
    obs = telemetry_from_args(args, arch="egru-spiral", mode="online",
                              backend=args.rtrl_backend,
                              col_compact=run["col_compact"])
    out = run_with_restart(online_trainers(args, run, obs))
    summary = {"arch": "egru-spiral", "mode": "online", "layers": args.layers,
               "backend": args.rtrl_backend, "device": str(run["device"]),
               "update_every": args.update_every, "updates": out["updates"],
               "final_step": out["final_step"], "restarts": out["restarts"],
               "stragglers": out["stragglers"],
               "carry_bytes": out["carry_bytes"],
               "carry_live_bytes": out["carry_live_bytes"],
               **_loss_fields(out["metrics"]),
               "overflow": max((w.get("overflow", 0.0)
                                for w in out["windows"]), default=0.0),
               "median_window_ms": _median_ms(out["windows"])}
    if args.rewire != "off":
        summary["rewire"] = args.rewire
        summary["rewire_events"] = out["rewire_events"]
    if "guard" in out:
        g = out["guard"]
        summary["guard"] = {"faults": g["faults"],
                            "rollbacks": g["rollbacks"],
                            "recovered": len(g["recoveries"]),
                            "quarantined": len(g["quarantined"])}
    finish_run(obs, "train egru-spiral (online RTRL)", summary)
    print(json.dumps(summary))
    out["summary"] = summary
    return out


def build_lm(args) -> dict:
    """Everything the online token LM needs, on the resolved device, as
    build_online's dict: cfg, engine, vocab, width, masks, params (masked)
    and their factory, opt, learner, stream, device, updates.  Every
    refusal comes before anything is written."""
    from repro_torch.cells import resolve_cell
    from repro_torch.cells import rglru as RG
    from repro_torch.cells.snn import SNNConfig
    from repro_torch.core import sparse_rtrl as SP
    from repro_torch.core.cells import EGRUConfig
    from repro_torch.core.learner import LearnerSpec, make_learner
    from repro_torch.data.tokens import token_lm_stream
    from repro_torch.optim.optimizers import make_optimizer, masked

    if not args.online:
        raise SystemExit(f"--arch {args.arch} is an online streaming "
                         f"workload — pass --online (--steps counts "
                         f"optimizer updates)")
    engine = LM_ARCHS[args.arch]
    _refuse_unread(args, {**_SPIRAL_FLAGS, "production_mesh": False}
                   if engine == "sparse"
                   else {**_SPIRAL_FLAGS, **_EGRU_FLAGS,
                         "production_mesh": False})
    if engine == "eprop" and args.sparsity > 0.0:
        raise SystemExit("--sparsity is not wired for snn-lm (no "
                         "parameter-mask convention for the spiking cell)")
    device = resolve_device(args.device)
    vocab = 16 if args.smoke else args.vocab
    width = min(args.width, 32) if args.smoke else args.width
    mask_gen = torch.Generator().manual_seed(2 * args.seed + 1)
    masks = None
    if engine == "sparse":
        cfg = EGRUConfig(n_hidden=width, n_in=vocab, n_out=vocab, kind="gru")
        if args.sparsity > 0.0:
            masks = SP.make_masks(cfg, mask_gen, args.sparsity, device=device)
        col_compact = args.rtrl_backend == "compact_fused" or (
            masks is not None and args.rtrl_backend != "dense")
        spec = LearnerSpec(engine="sparse", cfg=cfg, backend=args.rtrl_backend,
                           capacity=args.capacity, col_compact=col_compact)
        if args.rtrl_backend != "dense":
            layout = SP.flat_layout(cfg)
            live = int(SP.flat_col_mask(layout, masks, device="cpu").sum())
            print(f"influence columns: {live}/{layout.P} live (P_pad "
                  f"{layout.P_pad}); col-compact carry "
                  f"{'ON' if col_compact else 'OFF'}")
    elif engine == "diag_exact":
        cfg = RG.RGLRUCellConfig(n=width, n_in=vocab, n_out=vocab)
        if args.sparsity > 0.0:
            masks = RG.make_masks(cfg, mask_gen, args.sparsity, device=device)
        spec = LearnerSpec(engine="diag_exact", cfg=cfg)
    else:
        cfg = SNNConfig(n=width, n_in=vocab, n_out=vocab)
        spec = LearnerSpec(engine="eprop", cfg=cfg)
    cell = resolve_cell(cfg)

    def make_params():
        params = cell.init_params(
            torch.Generator().manual_seed(2 * args.seed), device=device)
        if masks is None:
            return params
        return (SP.apply_masks if engine == "sparse"
                else RG.apply_masks)(params, masks)

    opt = make_optimizer("adamw", lr=args.lr)
    if masks is not None:
        opt_mask = dict(masks)
        opt_mask.setdefault("out", None)
        opt = masked(opt, opt_mask)
    return {"cfg": cfg, "engine": engine, "vocab": vocab, "width": width,
            "masks": masks, "make_params": make_params,
            "params": make_params(), "opt": opt,
            "learner": make_learner(spec), "device": device,
            "stream": token_lm_stream(args.batch, vocab, seq=args.seq,
                                      seed=1234 + args.seed),
            "updates": min(args.steps, 10) if args.smoke else args.steps}


def train_lm_online(args) -> dict:
    """The online token LM; `--steps` counts optimizer updates.  Returns
    the trainer's result plus the printed summary."""
    from repro_torch.runtime.trainer import run_with_restart
    run = build_lm(args)
    obs = telemetry_from_args(args, arch=args.arch, mode="online",
                              engine=run["engine"], vocab=run["vocab"],
                              width=run["width"])
    out = run_with_restart(online_trainers(args, run, obs))
    summary = {"arch": args.arch, "mode": "online", "engine": run["engine"],
               "device": str(run["device"]), "vocab": run["vocab"],
               "width": run["width"], "update_every": args.update_every,
               "updates": out["updates"], "final_step": out["final_step"],
               "restarts": out["restarts"], "stragglers": out["stragglers"],
               "carry_bytes": out["carry_bytes"],
               **_loss_fields(out["metrics"]),
               "median_window_ms": _median_ms(out["windows"])}
    if run["engine"] == "sparse":
        summary["backend"] = args.rtrl_backend
        summary["overflow"] = max((w.get("overflow", 0.0)
                                   for w in out["windows"]), default=0.0)
    finish_run(obs, f"train {args.arch} (online token LM)", summary)
    print(json.dumps(summary))
    out["summary"] = summary
    return out


def offline_fns(args, cfg, masks, opt, col_compact: bool):
    """(loss_and_grads, step_fn) of the offline path:
    loss_and_grads(params, xs, labels) -> (loss, grads, stats) is
    `stacked_rtrl_loss_and_grads` with the run's backend; step_fn(params,
    opt_state, (xs, labels), step) adds the masked adamw update."""
    from repro_torch.core import stacked_rtrl as ST

    def loss_and_grads(params, xs, labels):
        return ST.stacked_rtrl_loss_and_grads(
            cfg, params, xs, labels, masks, backend=args.rtrl_backend,
            capacity=args.capacity, col_compact=col_compact,
            influence_dtype=args.influence_dtype)

    def step_fn(params, opt_state, batch, step):
        loss, grads, stats = loss_and_grads(params, *batch)
        params, opt_state = opt.update(grads, opt_state, params, step)
        metrics = {"loss": loss, "alpha": stats["alpha"].mean(),
                   "beta": stats["beta"].mean()}
        if "overflow" in stats:
            metrics["overflow"] = stats["overflow"].max()
        return params, opt_state, metrics

    return loss_and_grads, step_fn


def build_offline(args) -> dict:
    """Everything the offline run needs: build_online's common part plus
    loss_and_grads, step_fn and data_at (the batch of a step, on the
    device)."""
    run = _build_common(args)
    run["loss_and_grads"], run["step_fn"] = offline_fns(
        args, run["cfg"], run["masks"], run["opt"], run["col_compact"])
    batches = make_offline_data(run["cfg"])

    def data_at(step):                   # step-keyed: replay-exact
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            run["device"]) for a in batches(step))

    run["data_at"] = data_at
    return run


def offline_trainers(args, run):
    """make_trainer(attempt) for `run_with_restart`: a Trainer with fresh
    params, `--fail-at` armed on attempt 0 only."""
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    def make_trainer(attempt=0):
        params = run["make_params"]()
        tcfg = TrainerConfig(total_steps=args.steps,
                             ckpt_every=args.ckpt_every,
                             ckpt_dir=args.ckpt_dir,
                             fail_at_step=args.fail_at if attempt == 0 else -1,
                             metrics_path=args.metrics)
        return Trainer(tcfg, run["step_fn"], params, run["opt"].init(params),
                       run["data_at"])

    return make_trainer


def train_egru_offline(args) -> dict:
    """Whole-sequence exact-RTRL training; `--steps` counts sequences."""
    from repro_torch.runtime.trainer import run_with_restart
    run = build_offline(args)
    out = run_with_restart(offline_trainers(args, run))
    summary = {"arch": "egru-spiral", "mode": "offline",
               "layers": args.layers, "backend": args.rtrl_backend,
               "device": str(run["device"]),
               "final_step": out["final_step"], "restarts": out["restarts"],
               "stragglers": out["stragglers"],
               **_loss_fields(out["metrics"]),
               "median_step_ms": _median_ms(out["steps"])}
    obs = telemetry_from_args(args, arch="egru-spiral", mode="offline",
                              backend=args.rtrl_backend,
                              col_compact=run["col_compact"])
    finish_run(obs, "train egru-spiral (offline RTRL)", summary)
    print(json.dumps(summary))
    out["summary"] = summary
    return out


def parse_args(argv=None):
    from repro_torch.runtime.trainer import default_ckpt_dir
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
                    help="online: cap the run at 12 updates (10, vocab 16 "
                         "and width <= 32 for the *-lm archs)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="checkpoint every N updates (online) or steps "
                         "(offline); 0: no periodic checkpoint")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint root; a run resumes from its newest "
                         "valid checkpoint (default <tempdir>/"
                         "repro_torch_ckpt)")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject one crash at this update (online) or step "
                         "(offline); the supervisor restarts from the last "
                         "checkpoint")
    ap.add_argument("--metrics", default=None,
                    help="append the logged metric records to this file as "
                         "JSON lines")
    ap.add_argument("--layers", type=int, default=1,
                    help="stacked depth L (16 units a layer)")
    ap.add_argument("--rewire", choices=["off", "set", "rigl"],
                    default="off",
                    help="online dynamic sparsity: prune-and-regrow the "
                         "masks at update boundaries with exact carry "
                         "migration ('set' random regrowth, 'rigl' "
                         "gradient-magnitude regrowth)")
    ap.add_argument("--rewire-every", type=int, default=50,
                    help="optimizer updates between rewire events")
    ap.add_argument("--rewire-frac", type=float, default=0.3,
                    help="initial rewired fraction of live weights per "
                         "tensor (cosine-decayed to 0 over the run)")
    ap.add_argument("--guard", action="store_true",
                    help="online: the stream guard — health checks every "
                         "update, rollback and replay from a snapshot ring "
                         "under an escalating degradation policy")
    ap.add_argument("--guard-ring", type=int, default=4,
                    help="known-good snapshots retained for rollback")
    ap.add_argument("--guard-policy", default="full",
                    help="escalation ladder: a preset (full | strict | "
                         "replay-only) or a comma-separated list from "
                         "{replay, clip, skip_update, quarantine}")
    ap.add_argument("--inject-nan-at", type=int, default=-1,
                    help="fault injection (online): stream steps [S, S+len) "
                         "read NaN inputs, on every attempt")
    ap.add_argument("--inject-nan-len", type=int, default=1,
                    help="length of the injected NaN input window")
    ap.add_argument("--inject-corrupt-at", type=int, default=-1,
                    help="fault injection (online): poison one influence "
                         "element after this update commits")
    ap.add_argument("--vocab", type=int, default=64,
                    help="token vocabulary of the *-lm archs (--smoke: 16)")
    ap.add_argument("--width", type=int, default=64,
                    help="recurrent state width of the *-lm archs "
                         "(--smoke: at most 32)")
    ap.add_argument("--lr", type=float, default=3e-3,
                    help="adamw learning rate of the *-lm archs")
    ap.add_argument("--batch", type=int, default=4,
                    help="streams in the batch of the *-lm archs")
    ap.add_argument("--seq", type=int, default=64,
                    help="tokens a sequence of the *-lm archs' stream")
    ap.add_argument("--production-mesh", action="store_true",
                    help="LM families: train over the 16 x 16 production "
                         "mesh (256 ranks)")
    add_obs_args(ap)
    args = ap.parse_args(argv)
    if args.ckpt_dir is None:
        args.ckpt_dir = default_ckpt_dir()
    return args


def _model_lm_mesh(args, device):
    """The LM run's mesh: the production mesh when asked for, the host
    mesh over an initialized process group, else None (one device).  A
    process started by torchrun (WORLD_SIZE > 1 in its environment) joins
    its group first: gloo on the CPU, nccl on the card (its LOCAL_RANK's)."""
    import os
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("gloo" if device.type == "cpu" else "nccl")
    if args.production_mesh:
        return mesh_lib.make_production_mesh(device=device)
    if dist.is_initialized():
        return mesh_lib.make_host_mesh(device=device)
    return None


def build_model_lm(args, mesh=None) -> dict:
    """The LM family run of `args`: cfg, device, opt, the train step and
    data_at (the step's batch on the device), and the mesh (`mesh`, else
    `_model_lm_mesh`) with the step's shardings.  The refusals come
    first."""
    from repro_torch.configs import ARCHS as MODEL_ARCHS
    from repro_torch.configs import NOT_PORTED, get_config, smoke_config
    from repro_torch.launch import steps as steps_lib

    if args.arch not in MODEL_ARCHS:
        raise SystemExit(f"unknown --arch {args.arch}")
    if args.arch in NOT_PORTED:
        raise SystemExit(f"not ported yet: --arch {args.arch} (ROADMAP Queue "
                         "1 item 14)")
    _refuse_unread(args, {**_SPIRAL_FLAGS, **_EGRU_FLAGS, "online": False,
                          "sparsity": 0.0, "update_every": 8,
                          **{k: v for k, v in _LM_FLAGS.items()
                             if k not in ("batch", "seq")}})
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    device = resolve_device(args.device)
    mesh = mesh if mesh is not None else _model_lm_mesh(args, device)
    opt = steps_lib.default_optimizer(cfg)
    built = None
    if mesh is not None:
        from repro_torch.configs.base import ShapeSuite
        built = steps_lib.make_train_step(
            cfg, opt, ShapeSuite("cli", args.seq, args.batch, "train"),
            mesh=mesh)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    batches = {"n_patches": cfg.n_patches} if cfg.n_patches else {}
    if cfg.family == "encdec":       # the stub audio frontend's frames
        batches["frames"] = (cfg.enc_seq, cfg.d_model)

    def data_at(step):                   # step-keyed: replay-exact
        from repro_torch.data.tokens import synthetic_token_batches
        b = next(synthetic_token_batches(args.batch, args.seq, cfg.vocab_size,
                                         seed=1234 + step, **batches))
        return {k: torch.from_numpy(v).to(device, torch.long
                                         if v.dtype.kind == "i" else None)
                for k, v in b.items()}

    return {"cfg": cfg, "device": device, "opt": opt, "data_at": data_at,
            "mesh": mesh,
            "shardings": None if built is None else built.shardings,
            "step_fn": steps_lib.make_train_step(cfg, opt) if built is None
            else built.fn}


def model_lm_trainers(args, run):
    """make_trainer(attempt) for `run_with_restart`: a Trainer with the
    parameters drawn anew from torch.Generator(--seed) on the device,
    `--fail-at` armed on attempt 0 only.  Over a mesh the parameters and
    state are placed by the step's shardings, and restore onto them."""
    from repro_torch.models import get_model
    from repro_torch.models.module import materialize
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg, device, sh = run["cfg"], run["device"], run["shardings"]

    def make_trainer(attempt=0):
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = materialize(get_model(cfg).specs(cfg), gen)
        opt_state, shardings = None, None
        if sh is not None:
            from repro_torch.launch.steps import init_opt_state
            from repro_torch.sharding import place_tree
            params = place_tree(params, sh["params"])
            opt_state = init_opt_state(run["opt"], params, sh["opt"])
            shardings = (sh["params"], sh["opt"])
        tcfg = TrainerConfig(total_steps=args.steps,
                             ckpt_every=args.ckpt_every,
                             ckpt_dir=args.ckpt_dir,
                             fail_at_step=args.fail_at if attempt == 0 else -1,
                             metrics_path=args.metrics)
        return Trainer(tcfg, run["step_fn"], params,
                       run["opt"].init(params) if opt_state is None
                       else opt_state, run["data_at"], shardings=shardings)

    return make_trainer


def train_model_lm(args) -> dict:
    """Offline LM training of a model family; `--steps` counts steps."""
    from repro_torch.runtime.trainer import run_with_restart
    run = build_model_lm(args)
    out = run_with_restart(model_lm_trainers(args, run))
    summary = {"arch": args.arch, "device": str(run["device"]),
               "final_step": out["final_step"], "restarts": out["restarts"],
               "stragglers": out["stragglers"],
               **_loss_fields(out["metrics"]),
               "median_step_ms": _median_ms(out["steps"])}
    mesh = run["mesh"]
    if mesh is not None:
        from repro_torch.models.module import mesh_shape
        summary["mesh"] = mesh_shape(mesh)
        summary["pure_dp"] = run["shardings"]["pure_dp"]
    out["summary"] = summary
    if mesh is not None and mesh.get_rank() != 0:
        return out
    obs = telemetry_from_args(args, arch=args.arch)
    finish_run(obs, f"train {args.arch}", summary)
    print(json.dumps(summary))
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.arch in LM_ARCHS:
        return train_lm_online(args)
    if args.arch not in ARCHS:
        return train_model_lm(args)
    return (train_egru_online if args.online else train_egru_offline)(args)


if __name__ == "__main__":
    main()
