#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of the JAX
package (`src/repro`), and it has no CPU path: without CUDA, or outside a
checkout, it exits non-zero and prints no result.  Phases:

  1. device: the card's name and power limit (nvidia-smi), then every
     kernel of the port built from the sources in the checkout;
  2. K1 (`kernels/compact_fused.py::fused_update`, the CUDA kernel) against
     its plain PyTorch version on the card, f32 and bf16 carries, at (a)
     the main path's shapes with operands from a real step, (b) n=256,
     K=256, Pc_pad=20864, B=4 with ragged counts, (c) edge cases (a full
     example, a one-row example, count_prev = 0); dead rows must be exactly
     zero.  Times at (a) and (b): kernel, plain version, the bound, and as
     `library_ms` a torch.baddbmm on pre-gathered tiles (a partial
     yardstick the port never calls);
  3. the main path: `repro_torch.launch.train --arch egru-spiral --online
     --rtrl-backend compact_fused --sparsity 0.8 --update-every 8 --steps
     20` on the card, in-process, with K1's launch count read just after;
     then the same seed with the `compact` backend (torch ops, no kernel),
     whose first window's loss and gradients must agree with the fused
     run's, and with the plain run on the CPU; then a torch.profiler trace
     of two more windows (device busy share, launches per step);
  4. one JSON line {"kernels": [...]} for every ported kernel, then the
     result line {"ok": true, "device": {...}}.

Tolerances: a float32 kernel result is within 1e-5 of the largest
magnitude of the plain version's (the sums associate differently); a bf16
result within one bf16 rounding step (2^-7 relative) more.  Window
gradients across backends and devices: 1e-5 of each leaf's largest entry.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, f32 CUDA-core FLOP/s
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
F32_REL = 1e-5
BF16_STEP = 2.0 ** -7


def main_argv(backend="compact_fused", *extra):
    """The main path's launcher arguments (no --device: it runs on CUDA)."""
    return ["--arch", "egru-spiral", "--online", "--rtrl-backend", backend,
            "--sparsity", "0.8", "--update-every", "8", "--steps", "20",
            "--seed", "0", *extra]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters, warmup=3):
    """Mean ms per call over `iters` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_bound(torch, ops):
    """Least time (ms) for the fused update on these inputs: the larger of
    the bytes it must move over HBM bandwidth and its f32 FMA work over the
    CUDA-core peak, counting only what the live counts need."""
    J, vals, mbar, hp, idx_new, idx_prev, cn, cp = ops
    B, K, Pc = vals.shape
    es = vals.element_size()
    cn = cn.clamp(0, K).double().cpu()
    cp = cp.clamp(0, K).double().cpu()
    nbytes = float(cp.sum() * Pc * es            # live rows of vals, read
                   + cn.sum() * Pc * 4           # live rows of mbar, read
                   + (cn * cp).sum() * 4         # gathered J entries
                   + cn.sum() * 4 + 2 * B * K * 4 + 2 * B * 4   # hp, idx, counts
                   + B * K * Pc * es)            # every output row, written
    flops = float((2 * cn * cp * Pc).sum() + 2 * cn.sum() * Pc)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, flops


# ---------------------------------------------------------------------------
# phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

def ragged_operands(torch, dev, B, K, n, Pc, count_new, count_prev, seed):
    """Operands honouring the carry contract with the given live counts."""
    g = torch.Generator().manual_seed(seed)
    idx_new = torch.full((B, K), -1, dtype=torch.int32)
    idx_prev = torch.full((B, K), -1, dtype=torch.int32)
    for b in range(B):
        idx_new[b, :count_new[b]] = torch.randperm(n, generator=g)[
            :count_new[b]].sort().values.int()
        idx_prev[b, :count_prev[b]] = torch.randperm(n, generator=g)[
            :count_prev[b]].sort().values.int()
    gd = torch.Generator(device=dev).manual_seed(seed)
    J = torch.randn((B, n, n), generator=gd, device=dev)
    vals = torch.randn((B, K, Pc), generator=gd, device=dev)
    mbar = torch.randn((B, K, Pc), generator=gd, device=dev)
    hp = torch.rand((B, K), generator=gd, device=dev)
    idx_new, idx_prev = idx_new.to(dev), idx_prev.to(dev)
    vals *= (idx_prev >= 0)[:, :, None]
    hp *= (idx_new >= 0)
    cn = torch.tensor(count_new, dtype=torch.int32, device=dev)
    cp = torch.tensor(count_prev, dtype=torch.int32, device=dev)
    return [J, vals, mbar, hp, idx_new, idx_prev, cn, cp]


def with_carry_dtype(torch, ops, dtype):
    ops = list(ops)
    ops[1] = ops[1].to(dtype).contiguous()
    return ops


def compare_k1(torch, CF, ops, label):
    """Kernel vs plain version on the card; returns max abs error."""
    out = CF.fused_update(*ops)
    torch.cuda.synchronize()                    # a fault surfaces here
    ref = CF.fused_reference(*ops)
    check(out.dtype == ops[1].dtype and out.shape == ops[1].shape,
          f"{label}: output {out.dtype} {tuple(out.shape)}")
    o, r = out.float(), ref.float()
    check(bool(torch.isfinite(o).all()), f"{label}: non-finite output")
    err = (o - r).abs()
    scale = max(float(r.abs().max()), 1.0)
    if ops[1].dtype == torch.float32:
        ok = float(err.max()) <= F32_REL * scale
    else:
        ok = bool((err <= BF16_STEP * r.abs() + F32_REL * scale).all())
    check(ok, f"{label}: kernel vs plain max abs err {float(err.max()):.3e} "
              f"(scale {scale:.3e})")
    K = ops[1].shape[1]
    rows = torch.arange(K, device=o.device)[None, :]
    dead = rows >= ops[6].clamp(max=K)[:, None]
    check(bool((o[dead] == 0).all()), f"{label}: dead rows not exactly zero")
    log(f"K1 {label}: max_abs_err {float(err.max()):.3e} "
        f"(scale {scale:.3e}), dead rows exactly 0: "
        f"{int(dead.sum())} rows")
    return float(err.max())


def time_k1(torch, CF, CK, ops, iters):
    """(kernel ms, plain ms, library ms, bound ms, bound_by)."""
    ms = time_ms(torch, lambda: CF.fused_update(*ops), iters)
    plain = time_ms(torch, lambda: CF.fused_reference(*ops), max(iters // 10, 3))
    J, vals, mbar, hp, idx_new, idx_prev = ops[:6]
    Jgg = CK.gather_j_tiles(J, idx_new, idx_prev).contiguous()
    vf = vals.float().contiguous()
    lib = time_ms(torch, lambda: torch.baddbmm(mbar, Jgg, vf), iters)
    bound, by, nbytes, flops = k1_bound(torch, ops)
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "flops": flops}


def main_path_operands(torch, TRAIN, SP, ON, dev, steps=5):
    """K1's operands at a live step of the main path: the launcher's run
    (same seed), stepped a few times from init, then the next step's
    kernel operands."""
    run = TRAIN.build_online(TRAIN.parse_args(main_argv()))
    cfg, learner = run["cfg"], run["learner"]
    xs, ys = stream_window(torch, run, steps + 1)
    carry = learner.init(run["params"], run["masks"], (xs[0], ys[0]),
                         t_total=8.0)
    carry, _, _, _ = ON.stream_grads(learner, carry, xs[:steps], ys[:steps])
    lcfg = cfg.layer_cfg(0)
    layout = SP.flat_layout(lcfg)
    cl = SP.col_layout(layout, run["masks"][0], device=dev)
    w = {k: v for k, v in carry["params"].items() if k != "out"}
    _, _, ops, _ = SP.fused_step_operands(lcfg, w, layout, carry["a"],
                                          carry["vals"], carry["idx"],
                                          xs[steps], cl=cl)
    return list(ops)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def stream_window(torch, run, k):
    """The first k stream steps of a built run, on its device."""
    import numpy as np
    xs, ys = zip(*(run["stream"](t) for t in range(k)))
    return (torch.from_numpy(np.stack(xs)).to(run["device"]),
            torch.from_numpy(np.stack(ys)).to(run["device"]))


def first_window_grads(torch, TRAIN, ON, backend, *extra):
    """Loss and gradients of the main path's first window (k=8)."""
    run = TRAIN.build_online(TRAIN.parse_args(main_argv(backend, *extra)))
    xs, ys = stream_window(torch, run, 8)
    carry = run["learner"].init(run["params"], run["masks"], (xs[0], ys[0]),
                                t_total=8.0)
    _, loss, grads, _ = ON.stream_grads(run["learner"], carry, xs, ys)
    return float(loss), grads


def compare_grads(tree_leaves, a, b, label):
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = x.double().cpu(), y.double().cpu()
        scale = max(float(y.abs().max()), 1e-3)
        err = float((x - y).abs().max())
        check(err <= F32_REL * scale,
              f"{label}: gradient leaf differs by {err:.3e} (scale {scale:.3e})")
        worst = max(worst, err / scale)
    log(f"first-window gradients {label}: max rel err {worst:.3e}")


def trace_main_path(torch, TRAIN, ON, warm=2, traced=2, k=8):
    """Where a main-path window's time goes: a torch.profiler trace of
    `traced` windows after `warm` untraced ones, in a run of its own (the
    window times come from the untraced run).  Reports device kernels per
    stream step, the device's busy and idle share of the traced wall time,
    K1's device time per launch and the kernels that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run = TRAIN.build_online(TRAIN.parse_args(main_argv()))
    tr = ON.OnlineTrainer(
        ON.OnlineTrainerConfig(total_steps=warm * k, update_every=k),
        run["learner"], run["opt"], run["params"], run["masks"],
        run["stream"], device=run["device"])
    tr.run()
    tr.cfg.total_steps = (warm + traced) * k
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log("trace: the profiler recorded no device events: device busy "
            "share not measured")
        return
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    steps = traced * k
    by_name = {}
    for e in dev:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    k1 = [v for n, v in by_name.items() if "fused_update_kernel" in n]
    k1_us = sum(v[0] for v in k1) / max(sum(v[1] for v in k1), 1)
    log(f"trace ({traced} windows, {steps} stream steps, profiler on): "
        f"{len(dev) / steps:.1f} device ops per stream step, device busy "
        f"{busy:.0f} us of {wall_us:.0f} us wall "
        f"(idle share {1 - busy / wall_us:.3f}), K1 device time "
        f"{k1_us:.2f} us per launch")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    for n, (tot, cnt) in top:
        log(f"  {tot / steps:8.2f} us/step  x{cnt / steps:5.1f}/step  {n[:90]}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}: run it "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import sparse_rtrl as SP
    from repro_torch.kernels import _build, compact as CK
    from repro_torch.kernels import compact_fused as CF
    from repro_torch.launch import train as TRAIN
    from repro_torch.runtime import online as ON
    from repro_torch.tree import tree_leaves

    # -- phase 1: device and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    build_s = _build.build()
    for k in _build.KERNELS:
        _build.load(k)
        log(f"built {k}: {_build.library_path(k).name}")
        for line in _build.build_log.get(k, "").splitlines():
            if "ptxas info" in line:
                log(f"  {line.strip()}")
    log(f"kernel build: {build_s:.2f} s (load {time.perf_counter() - t0:.2f} s)")

    # -- phase 2: K1 against its plain version ------------------------------
    main_ops = main_path_operands(torch, TRAIN, SP, ON, dev)
    B, K, Pc = main_ops[1].shape
    log(f"K1 (a) main path: B={B} n={main_ops[0].shape[-1]} K={K} "
        f"Pc_pad={Pc}, count_new {main_ops[6].tolist()}, "
        f"count_prev {main_ops[7].tolist()}")
    err_main = compare_k1(torch, CF, main_ops, "(a) f32")
    compare_k1(torch, CF, with_carry_dtype(torch, main_ops, torch.bfloat16),
               "(a) bf16")
    big = dict(B=4, K=256, n=256, Pc=20864, count_new=[256, 140, 96, 1],
               count_prev=[256, 100, 150, 60])
    big_ops = ragged_operands(torch, dev, seed=1, **big)
    compare_k1(torch, CF, big_ops, "(b) n=256 f32")
    big_bf16 = with_carry_dtype(torch, big_ops, torch.bfloat16)
    compare_k1(torch, CF, big_bf16, "(b) n=256 bf16")
    edge = ragged_operands(torch, dev, B=3, K=16, n=40, Pc=384,
                           count_new=[16, 1, 9], count_prev=[16, 7, 0],
                           seed=2)
    compare_k1(torch, CF, edge, "(c) edges f32")
    compare_k1(torch, CF, with_carry_dtype(torch, edge, torch.bfloat16),
               "(c) edges bf16")
    times = {"(a) f32": time_k1(torch, CF, CK, main_ops, 500),
             "(b) n=256 f32": time_k1(torch, CF, CK, big_ops, 20),
             "(b) n=256 bf16": time_k1(torch, CF, CK, big_bf16, 20)}
    for label, t in times.items():
        log(f"K1 time {label}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, baddbmm on pre-gathered tiles "
            f"(partial yardstick) {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']:.0f} B, "
            f"{t['flops']:.0f} FLOP)")
    log("K1 times json: " + json.dumps(times))

    # -- phase 3: the main path ---------------------------------------------
    CF.fused_update.launches = 0
    fused = TRAIN.main(main_argv())
    launches = CF.fused_update.launches
    steps = fused["final_step"]
    log(f"main path: K1 launches {launches} over {steps} stream steps")
    check(launches == steps and steps == 160,
          f"K1 launched {launches} times over {steps} stream steps")
    losses = [w["loss"] for w in fused["windows"]]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(fused["summary"]["overflow"] == 0, "row capacity overflowed")
    CF.fused_update.launches = 0
    plain = TRAIN.main(main_argv("compact"))
    check(CF.fused_update.launches == 0, "the compact backend launched K1")
    l_f, l_c = fused["windows"][0]["loss"], plain["windows"][0]["loss"]
    check(abs(l_f - l_c) <= F32_REL * abs(l_c),
          f"first window loss: compact_fused {l_f} vs compact {l_c}")
    lf, gf = first_window_grads(torch, TRAIN, ON, "compact_fused")
    lc, gc = first_window_grads(torch, TRAIN, ON, "compact")
    lp, gp = first_window_grads(torch, TRAIN, ON, "compact", "--device", "cpu")
    check(abs(lf - lc) <= F32_REL * abs(lc) and abs(lf - lp) <= F32_REL * abs(lp),
          f"first window loss {lf} (fused) / {lc} (compact) / {lp} (cpu)")
    compare_grads(tree_leaves, gf, gc, "compact_fused vs compact (cuda)")
    compare_grads(tree_leaves, gf, gp, "compact_fused (cuda) vs compact (cpu)")
    s = fused["summary"]
    log(f"main path: first loss {s['first_loss']:.6f}, final loss "
        f"{s['final_loss']:.6f}, first window {l_f:.6f} (compact {l_c:.6f}), "
        f"median window {s['median_window_ms']:.3f} ms "
        f"(compact {plain['summary']['median_window_ms']:.3f} ms), "
        f"carry {s['carry_bytes']} bytes")

    trace_main_path(torch, TRAIN, ON)

    # -- phase 4: the kernels line and the result ---------------------------
    t = times["(a) f32"]
    kernels = [{"name": "compact_fused", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/compact_fused.cu",
                "replaces": "src/repro/kernels/compact_fused.py:295",
                "launches": launches, "max_abs_err": err_main,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
