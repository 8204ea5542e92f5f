#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of the JAX
package (`src/repro`), and it has no CPU path: without CUDA, or outside a
checkout, it exits non-zero and prints no result.  Phases:

  1. device: the card's name and power limit (nvidia-smi), then every
     kernel of the port built from the sources in the checkout (one nvcc
     per source, all at once);
  2. K1 (`kernels/compact_fused.py::fused_update`, the CUDA kernel) against
     its plain PyTorch version on the card, f32 and bf16 carries, at (a)
     the main path's shapes with operands from a real step, (b) n=256,
     K=256, Pc_pad=20864, B=4 with ragged counts, (c) edge cases (a full
     example, a one-row example, count_prev = 0); dead rows must be exactly
     zero.  Times at (a) and (b): kernel, plain version, the bound, and as
     `library_ms` a torch.baddbmm on pre-gathered tiles (a partial
     yardstick the port never calls);
  3. K2 (`kernels/influence.py::influence_update`, the CUDA kernel) against
     its plain version, at (a) the pallas main path's shapes with operands
     from a real step, full width (P_pad=1024) and column-compact
     (Pc_pad=256), (b) n=256, P=20864, B=4 with all four block skips in
     play, (c) edge cases (padding, a dead example, M all zero, no masks).
     Dead row and column blocks must be exactly zero, and the kernel's
     executed-block counter must equal `realized_block_savings` times the
     block count.  Times at (a) and (b): kernel, plain version, the bound,
     and as `library_ms` torch.baddbmm(M-bar, J-hat, M) with TF32 off;
  4. the main paths: `repro_torch.launch.train --arch egru-spiral --online
     --rtrl-backend B --sparsity 0.8 --update-every 8 --steps 20` on the
     card, in-process, for B = compact_fused (K1 launches counted), pallas
     (K2 launches counted), dense and compact, each with both counts set
     to 0 just before and read just after; then the first window's loss
     and gradients of every backend on the card, of pallas and compact on
     the CPU and of the BPTT oracle on the card must agree; then a
     torch.profiler trace of two more windows of compact_fused and of
     pallas (device busy share, launches per step);
  5. one JSON line {"kernels": [...]} for every ported kernel, then the
     result line {"ok": true, "device": {...}}.

Tolerances: a float32 kernel result is within 1e-5 of the largest
magnitude of the plain version's (the sums associate differently); a bf16
result within one bf16 rounding step (2^-7 relative) more.  Window
gradients across backends, devices and BPTT: 1e-5 of each leaf's largest
entry (BPTT on the surviving parameters: it also gives the pruned ones a
gradient, which the masked optimizer drops).
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
# phase 3: K2 against its plain version
# ---------------------------------------------------------------------------

def k2_masks(ops):
    return dict(row_mask=ops[4], prev_mask=ops[5], col_mask=ops[6],
                jmask=ops[7])


def k2_bound(torch, ops):
    """Least time (ms) for the block-sparse update on these padded
    operands: the bytes it must move over HBM bandwidth — the live rows of
    M at live columns, the live blocks of M-bar, the J tiles of executed
    blocks, hp, and the whole output written — against 2*8*8*128 f32 FLOP
    per executed (b, kb, lb, pb) block over the CUDA-core peak."""
    from repro_torch.kernels import influence as IN
    hp, J, M, Mbar, row, prev, cols, jm = ops
    B, n_p, P_p = M.shape
    row, prev, jm = ((t != 0).double().cpu() for t in (row, prev, jm))
    live_cols = float((cols != 0).sum()) * IN.BP
    pairs = torch.einsum("bk,bl,kl->bkl", row, prev, jm)   # executed (kb, lb)
    m_rows = float((pairs.sum(dim=1) > 0).sum()) * IN.BL   # rows of M used
    out_rows = float(row.sum()) * IN.BK
    nbytes = (m_rows * live_cols * 4 + out_rows * live_cols * 4
              + float(pairs.sum()) * IN.BK * IN.BL * 4 + out_rows * 4
              + B * n_p * P_p * 4)
    blocks = int(IN.executed_blocks(*(ops[4:])))
    flops = float(blocks) * 2 * IN.BK * IN.BL * IN.BP
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, flops


def compare_k2(torch, IN, OPS, unpadded, label):
    """Kernel vs plain version on the card, dead blocks exactly zero, and
    the executed-block counter against realized_block_savings.  Returns
    (max abs error, padded operands)."""
    ops = OPS.influence_operands(*unpadded)
    masks = k2_masks(ops)
    count = torch.zeros(1, dtype=torch.int64, device=ops[2].device)
    out = IN.influence_update(*ops[:4], **masks, block_count=count)
    torch.cuda.synchronize()                    # a fault surfaces here
    ref = IN.influence_reference(*ops[:4], **masks)
    check(out.dtype == torch.float32 and out.shape == ops[2].shape,
          f"K2 {label}: output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), f"K2 {label}: non-finite output")
    err = float((out - ref).abs().max())
    scale = max(float(ref.abs().max()), 1.0)
    check(err <= F32_REL * scale, f"K2 {label}: kernel vs plain max abs err "
                                  f"{err:.3e} (scale {scale:.3e})")
    live = (ops[4] != 0).repeat_interleave(IN.BK, 1)[:, :, None] \
        & (ops[6] != 0).repeat_interleave(IN.BP)
    check(bool((out[~live] == 0).all()),
          f"K2 {label}: dead row/column blocks not exactly zero")
    B = ops[2].shape[0]
    total = B * ops[4].shape[1] * ops[5].shape[1] * ops[6].shape[0]
    hp, _, M, _, jmask, col_mask = unpadded
    expect = OPS.realized_block_savings(hp, M, jmask, col_mask) * total
    check(abs(expect - round(expect)) < 1e-6 and int(count) == round(expect),
          f"K2 {label}: executed blocks {int(count)} vs "
          f"realized_block_savings x blocks {expect}")
    log(f"K2 {label}: B={B} n_p={ops[2].shape[1]} P_p={ops[2].shape[2]}, "
        f"max_abs_err {err:.3e} (scale {scale:.3e}), dead blocks exactly 0: "
        f"{int((~live).sum())} elements, executed blocks {int(count)} of "
        f"{total} = realized_block_savings {expect / total:.6f}")
    return err, ops


def time_k2(torch, IN, ops, iters):
    """(kernel ms, plain ms, library ms, bound ms, bound_by)."""
    masks = k2_masks(ops)
    ms = time_ms(torch, lambda: IN.influence_update(*ops[:4], **masks), iters)
    plain = time_ms(torch, lambda: IN.influence_reference(*ops[:4], **masks),
                    max(iters // 10, 3))
    hp, J, M, Mbar = ops[:4]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib = time_ms(torch, lambda: torch.baddbmm(Mbar, J, M), iters)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    bound, by, nbytes, flops = k2_bound(torch, ops)
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "flops": flops}


def k2_main_operands(torch, TRAIN, SP, ON, dev, *extra, steps=5):
    """K2's unpadded operands (hp, J-hat, M, M-bar, jmask, col_mask) at a
    live step of the pallas main path: the launcher's run (same seed),
    stepped a few times from init, then the next step's operands."""
    run = TRAIN.build_online(TRAIN.parse_args(main_argv("pallas", *extra)))
    cfg, learner = run["cfg"], run["learner"]
    xs, ys = stream_window(torch, run, steps + 1)
    carry = learner.init(run["params"], run["masks"], (xs[0], ys[0]),
                         t_total=8.0)
    carry, _, _, _ = ON.stream_grads(learner, carry, xs[:steps], ys[:steps])
    lcfg, masks = cfg.layer_cfg(0), run["masks"][0]
    layout = SP.flat_layout(lcfg)
    compact = carry["M"].shape[-1] != layout.P_pad
    cl = SP.col_layout(layout, masks, device=dev) if compact else None
    w = {k: v for k, v in carry["params"].items() if k != "out"}
    _, _, ops = SP.pallas_step_operands(
        lcfg, w, layout, carry["a"], carry["M"], xs[steps], cl=cl,
        col_mask=SP.flat_col_mask(layout, masks, device=dev),
        jmask=SP.flat_jmask(lcfg, masks))
    return list(ops)


def k2_synthetic(torch, dev, seed=1):
    """(b): B=4, n=256, P=20864 (K1's (b) width) with live new-row blocks
    32/18/12/1 and previous-row blocks 32/13/19/8 of 32, the J pattern and
    the column blocks at block density 0.5 (the J pattern asymmetric)."""
    B, n, P = 4, 256, 20864
    nb, npb = n // 8, P // 128
    g = torch.Generator().manual_seed(seed)

    def some_blocks(counts):
        m = torch.zeros((B, nb), dtype=torch.bool)
        for b, c in enumerate(counts):
            m[b, torch.randperm(nb, generator=g)[:c]] = True
        return m.repeat_interleave(8, 1).to(dev)

    rows, prev = some_blocks([32, 18, 12, 1]), some_blocks([32, 13, 19, 8])
    jb = torch.rand((nb, nb), generator=g) < 0.5
    jb[0, nb - 1], jb[nb - 1, 0] = True, False
    jmask = jb.repeat_interleave(8, 0).repeat_interleave(8, 1).float().to(dev)
    col_mask = (torch.rand((npb,), generator=g) < 0.5).repeat_interleave(
        128).float().to(dev)
    gd = torch.Generator(device=dev).manual_seed(seed)
    hp = torch.rand((B, n), generator=gd, device=dev) * rows
    Jhat = torch.randn((B, n, n), generator=gd, device=dev) * jmask.T
    M = torch.randn((B, n, P), generator=gd, device=dev)
    M *= prev[:, :, None]
    M *= col_mask
    Mbar = torch.randn((B, n, P), generator=gd, device=dev)
    Mbar *= col_mask
    return [hp, Jhat, M, Mbar, jmask, col_mask]


def k2_edges(torch, dev, seed=2):
    """(c): n=20 and P=130 (padded to 24 and 256): a masked case with an
    example whose rows are all dead, and the first step (M all zero) with
    neither jmask nor col_mask."""
    g = torch.Generator().manual_seed(seed)
    B, n, P = 3, 20, 130
    hp = torch.rand((B, n), generator=g)
    hp[torch.rand((B, n), generator=g) < 0.3] = 0.0
    hp[-1] = 0.0
    Jhat = torch.randn((B, n, n), generator=g)
    M = torch.randn((B, n, P), generator=g)
    M[torch.rand((B, n), generator=g) < 0.3] = 0.0
    Mbar = torch.randn((B, n, P), generator=g)
    jb = torch.rand((3, 3), generator=g) < 0.5
    jb[0, 2], jb[2, 0] = True, False
    jmask = jb.repeat_interleave(8, 0).repeat_interleave(8, 1)[:n, :n].float()
    col_mask = (torch.rand((P,), generator=g) < 0.5).float()
    masked = [hp, Jhat * jmask.T, M * col_mask, Mbar * col_mask, jmask,
              col_mask]
    first = [torch.rand((B, n), generator=g), Jhat, torch.zeros_like(M),
             Mbar, None, None]
    to = lambda ops: [None if t is None else t.to(dev) for t in ops]
    return to(masked), to(first)


# ---------------------------------------------------------------------------
# phase 4: the main paths
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


def tree_items(tree, prefix=""):
    """(path, leaf) pairs of a nested dict/list tree."""
    if isinstance(tree, dict):
        return [i for k, v in tree.items() for i in tree_items(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [i for k, v in enumerate(tree)
                for i in tree_items(v, f"{prefix}/{k}")]
    return [] if tree is None else [(prefix, tree)]


def bptt_first_window(torch, TRAIN, BP, ST):
    """The BPTT oracle's loss and gradients on the main path's first window
    (same seed, params, masks, 8 steps and label) on the card, the pruned
    parameters' gradients masked as the optimizer masks them."""
    run = TRAIN.build_online(TRAIN.parse_args(main_argv("dense")))
    xs, ys = stream_window(torch, run, 8)
    check(bool((ys == ys[0]).all()), "first window spans two sequences")
    params, cfg = run["params"], run["cfg"]
    single = dict(params["layers"][0], out=params["out"])
    loss, g, _ = BP.bptt_loss_and_grads(cfg.layer_cfg(0), single, xs, ys[0])
    grads = {"layers": [{k: v for k, v in g.items() if k != "out"}],
             "out": g["out"]}
    return float(loss), ST.apply_stacked_masks(grads, run["masks"])


def compare_grads(a, b, label):
    worst = 0.0
    ia, ib = tree_items(a), tree_items(b)
    check([k for k, _ in ia] == [k for k, _ in ib],
          f"{label}: gradient trees differ: {[k for k, _ in ia]} vs "
          f"{[k for k, _ in ib]}")
    for (_, x), (_, y) in zip(ia, ib):
        x, y = x.double().cpu(), y.double().cpu()
        scale = max(float(y.abs().max()), 1e-3)
        err = float((x - y).abs().max())
        check(err <= F32_REL * scale,
              f"{label}: gradient leaf differs by {err:.3e} (scale {scale:.3e})")
        worst = max(worst, err / scale)
    log(f"first-window gradients {label}: max rel err {worst:.3e}")


def trace_main_path(torch, TRAIN, ON, backend, kernel, warm=2, traced=2,
                    k=8):
    """Where a main-path window's time goes: a torch.profiler trace of
    `traced` windows after `warm` untraced ones, in a run of its own (the
    window times come from the untraced run).  Reports device kernels per
    stream step, the device's busy and idle share of the traced wall time,
    the port kernel's device time per launch and the kernels that take the
    most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run = TRAIN.build_online(TRAIN.parse_args(main_argv(backend)))
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
    kern = [v for n, v in by_name.items() if kernel in n]
    kern_us = sum(v[0] for v in kern) / max(sum(v[1] for v in kern), 1)
    log(f"trace {backend} ({traced} windows, {steps} stream steps, profiler "
        f"on): {len(dev) / steps:.1f} device ops per stream step, device busy "
        f"{busy:.0f} us of {wall_us:.0f} us wall "
        f"(idle share {1 - busy / wall_us:.3f}), {kernel} device time "
        f"{kern_us:.2f} us per launch")
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
    from repro_torch.core import bptt as BP, sparse_rtrl as SP
    from repro_torch.core import stacked_rtrl as ST
    from repro_torch.kernels import _build, compact as CK
    from repro_torch.kernels import compact_fused as CF
    from repro_torch.kernels import influence as IN, ops as OPS
    from repro_torch.launch import train as TRAIN
    from repro_torch.runtime import online as ON

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

    # -- phase 3: K2 against its plain version ------------------------------
    k2_full = k2_main_operands(torch, TRAIN, SP, ON, dev, "--col-compact", "off")
    k2_comp = k2_main_operands(torch, TRAIN, SP, ON, dev)
    _, k2_full_ops = compare_k2(torch, IN, OPS, k2_full, "(a) full width")
    err_k2, k2_comp_ops = compare_k2(torch, IN, OPS, k2_comp,
                                     "(a) column-compact")
    _, k2_big_ops = compare_k2(torch, IN, OPS, k2_synthetic(torch, dev),
                               "(b) n=256")
    edge_masked, edge_first = k2_edges(torch, dev)
    compare_k2(torch, IN, OPS, edge_masked, "(c) padded, dead example")
    compare_k2(torch, IN, OPS, edge_first, "(c) first step, no masks")
    k2_times = {"(a) full width": time_k2(torch, IN, k2_full_ops, 500),
                "(a) column-compact": time_k2(torch, IN, k2_comp_ops, 500),
                "(b) n=256": time_k2(torch, IN, k2_big_ops, 20)}
    del k2_big_ops
    for label, t in k2_times.items():
        log(f"K2 time {label}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, baddbmm {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']:.0f} B, "
            f"{t['flops']:.0f} FLOP)")
    log("K2 times json: " + json.dumps(k2_times))

    # -- phase 4: the main paths --------------------------------------------
    runs, launches = {}, {}
    for backend in ("compact_fused", "pallas", "dense", "compact"):
        CF.fused_update.launches = 0
        IN.influence_update.launches = 0
        runs[backend] = TRAIN.main(main_argv(backend))
        launches[backend] = (CF.fused_update.launches,
                             IN.influence_update.launches)
        out = runs[backend]
        steps = out["final_step"]
        log(f"main path {backend}: K1 launches {launches[backend][0]}, K2 "
            f"launches {launches[backend][1]} over {steps} stream steps")
        check(steps == 160, f"{backend}: {steps} stream steps, not 160")
        want = (steps if backend == "compact_fused" else 0,
                steps if backend == "pallas" else 0)
        check(launches[backend] == want,
              f"{backend}: (K1, K2) launches {launches[backend]}, "
              f"expected {want}")
        losses = [w["loss"] for w in out["windows"]]
        check(all(math.isfinite(v) for v in losses),
              f"{backend}: non-finite loss {losses}")
        check(out["summary"]["overflow"] == 0, f"{backend}: overflow")
    l_ref = runs["compact"]["windows"][0]["loss"]
    for backend, out in runs.items():
        l_b = out["windows"][0]["loss"]
        check(abs(l_b - l_ref) <= F32_REL * abs(l_ref),
              f"first window loss: {backend} {l_b} vs compact {l_ref}")
    firsts = {
        "compact_fused (cuda)": first_window_grads(torch, TRAIN, ON,
                                                   "compact_fused"),
        "pallas (cuda)": first_window_grads(torch, TRAIN, ON, "pallas"),
        "dense (cuda)": first_window_grads(torch, TRAIN, ON, "dense"),
        "pallas (cpu)": first_window_grads(torch, TRAIN, ON, "pallas",
                                           "--device", "cpu"),
        "compact (cpu)": first_window_grads(torch, TRAIN, ON, "compact",
                                            "--device", "cpu"),
        "BPTT oracle (cuda)": bptt_first_window(torch, TRAIN, BP, ST),
    }
    lc, gc = first_window_grads(torch, TRAIN, ON, "compact")
    for label, (lb, gb) in firsts.items():
        check(abs(lb - lc) <= F32_REL * abs(lc),
              f"first window loss {label} {lb} vs compact (cuda) {lc}")
        compare_grads(gb, gc, f"{label} vs compact (cuda)")
    for backend, out in runs.items():
        s = out["summary"]
        log(f"main path {backend}: first loss {s['first_loss']:.6f}, final "
            f"loss {s['final_loss']:.6f}, first window "
            f"{out['windows'][0]['loss']:.6f}, median window "
            f"{s['median_window_ms']:.3f} ms, carry {s['carry_bytes']} bytes")

    trace_main_path(torch, TRAIN, ON, "compact_fused", "fused_update_kernel")
    trace_main_path(torch, TRAIN, ON, "pallas", "influence_kernel")

    # -- phase 5: the kernels line and the result ---------------------------
    t1, t2 = times["(a) f32"], k2_times["(a) column-compact"]
    kernels = [{"name": "compact_fused", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/compact_fused.cu",
                "replaces": "src/repro/kernels/compact_fused.py:295",
                "launches": launches["compact_fused"][0],
                "max_abs_err": err_main,
                "ms": t1["ms"], "plain_ms": t1["plain_ms"],
                "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
                "library_ms": t1["library_ms"]},
               {"name": "influence", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/influence.cu",
                "replaces": "src/repro/kernels/influence.py:92",
                "launches": launches["pallas"][1],
                "max_abs_err": err_k2,
                "ms": t2["ms"], "plain_ms": t2["plain_ms"],
                "bound_ms": t2["bound_ms"], "bound_by": t2["bound_by"],
                "library_ms": t2["library_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
