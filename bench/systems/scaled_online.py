"""System `scaled_online`: the port's scaled sparse-RTRL engine trained online
through `repro_torch.runtime.online.OnlineTrainer`, as a user runs it.

One unit of work is one update window: `update_every` stream steps (one K1
launch each on backend compact_fused), the gradient read off the compact
carry, the masked adamw update and the window's one readback.  A window
completes batch * update_every tokens.

Set-up draws the parameters, the masks and the stream from the seed, builds
ONE trainer, and drives it through its first `CHECK_WINDOWS` windows with
the trainer's own `run` and the stream's own rows: these are the warm-up
and the windows the reference follows.  The activity of every step of
them, the optimizer's first moments after the first window, the parameters
and the influence carry after the last are copied to the host; that copy
is checking work and is kept out of `setup_s`.  The timed window then runs
the same trainer on.

The check (`check`) runs once the window has closed and the trainer is
freed: the plain reference (`bench/configs/<reference>.py`) follows the
same windows from the same arrays, and the judge compares.
"""
from __future__ import annotations

import contextlib
import importlib.util
import math
import statistics
import time
from pathlib import Path

import torch

from bench import generator

CHECK_WINDOWS = 3
CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"


def load_reference(name: str):
    """The plain reference module bench/configs/<name>.py."""
    path = CONFIG_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# The draw: parameters and masks from the seed, on the device
# ---------------------------------------------------------------------------

def _block_grid(rows: int, cols: int, block: int, density: float,
                gen, device) -> torch.Tensor:
    """A 0/1 grid of the [rows, cols] matrix's block x block blocks with
    exactly round(density * blocks) ones, at places drawn from `gen`."""
    br, bc = -(-rows // block), -(-cols // block)
    nb = br * bc
    live = torch.randperm(nb, generator=gen, device=device)[
        :int(round(density * nb))]
    grid = torch.zeros(nb, device=device)
    grid[live] = 1.0
    return grid.view(br, bc)


def _expand(grid: torch.Tensor, rows: int, cols: int,
            block: int) -> torch.Tensor:
    r = torch.arange(rows, device=grid.device) // block
    c = torch.arange(cols, device=grid.device) // block
    return grid[r][:, c].contiguous()


def _block_perm(size: int, block: int, gen, device) -> torch.Tensor:
    """A permutation of range(size) that moves whole blocks of `block`."""
    nb = -(-size // block)
    order = torch.randperm(nb, generator=gen, device=device)
    idx = (order[:, None] * block
           + torch.arange(block, device=device)).reshape(-1)
    return idx[idx < size]


def draw(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """(params, masks) by leaf name (the reference's LEAVES; masks "W",
    "R"), drawn on `device`.

    One canonical network comes from `network_seed`: W ~ N(0, 1/n_in),
    R ~ N(0, 1/n), theta = 0.1 |N(0, 1)|, W_out ~ N(0, 1/n), biases zero,
    and block masks with exactly round((1 - sparsity) * blocks) live blocks
    of mask_block x mask_block, W and R masked.  The seed then permutes its
    units and its inputs, a block at a time: every seed runs the same
    network in another order, and so does the same work, while its stream
    (the generator's, from the seed) brings its own inputs and labels."""
    n, n_in, n_out = cfg["n"], cfg["n_in"], cfg["n_out"]
    block, density = cfg["mask_block"], 1.0 - cfg["sparsity"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["network_seed"]))
    sizes = (n_in * n, n * n, n, n * n_out)
    z = torch.randn(sum(sizes), generator=gen, device=device)
    W, R, th, Wo = z.split(sizes)
    mW = _expand(_block_grid(n_in, n, block, density, gen, device),
                 n_in, n, block)
    mR = _expand(_block_grid(n, n, block, density, gen, device), n, n, block)
    W = W.view(n_in, n) / math.sqrt(n_in) * mW
    R = R.view(n, n) / math.sqrt(n) * mR
    Wo = Wo.view(n, n_out) / math.sqrt(n)
    perm = torch.Generator(device=device)
    perm.manual_seed(int(seed))
    u = _block_perm(n, block, perm, device)
    i = _block_perm(n_in, block, perm, device)
    masks = {"W": mW[i][:, u].contiguous(), "R": mR[u][:, u].contiguous()}
    params = {"W": W[i][:, u].contiguous(), "R": R[u][:, u].contiguous(),
              "b": torch.zeros(n, device=device),
              "theta": (0.1 * th.abs())[u].contiguous(),
              "out_W": Wo[u].contiguous(),
              "out_b": torch.zeros(n_out, device=device)}
    return params, masks


def program_tree(params: dict, masks: dict):
    """The drawn leaves as the port's parameter and mask trees."""
    n = params["R"].shape[0]
    ptree = {"v": {"W": params["W"].clone(), "R": params["R"].clone(),
                   "b": params["b"].clone()},
             "theta": params["theta"].clone(),
             "out": {"W": params["out_W"].clone(),
                     "b": params["out_b"].clone()}}
    ones = torch.ones(n, device=params["R"].device)
    mtree = {"v": {"W": masks["W"], "R": masks["R"], "b": ones},
             "theta": ones, "out": None}
    return ptree, mtree


def flat_leaves(tree: dict) -> dict:
    """The port's parameter-shaped tree -> leaves by the reference's names."""
    return {"W": tree["v"]["W"], "R": tree["v"]["R"], "b": tree["v"]["b"],
            "theta": tree["theta"], "out_W": tree["out"]["W"],
            "out_b": tree["out"]["b"]}


def _host(tree: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# The system
# ---------------------------------------------------------------------------

class ScaledOnline:
    """One trainer of the scaled engine over one seeded stream."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from repro_torch import optim
        from repro_torch.core.learner import LearnerSpec, make_learner
        from repro_torch.core.scaled_rtrl import ScaledRTRLConfig
        from repro_torch.runtime.online import (OnlineTrainer,
                                                OnlineTrainerConfig)
        t0 = time.perf_counter()
        self.cfg, self.seed = cfg, int(seed)
        self.device = torch.device(device)
        tcfg = cfg["train"]
        self.k = int(tcfg["update_every"])
        self.batch = int(cfg["batch"])
        self.stream = generator.make_stream(
            mix, seed=self.seed, batch=self.batch, n_in=cfg["n_in"],
            n_classes=cfg["n_out"])
        self.params0, self.masks = draw(cfg, self.seed, self.device)
        ptree, mtree = program_tree(self.params0, self.masks)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        scfg = ScaledRTRLConfig(
            n=cfg["n"], n_in=cfg["n_in"], n_out=cfg["n_out"],
            batch=self.batch, n_layers=cfg["n_layers"],
            beta_capacity=cfg["beta_capacity"], sparsity=cfg["sparsity"],
            mask_block=cfg["mask_block"], gamma=cfg["gamma"],
            eps=cfg["eps"])
        self.learner = make_learner(LearnerSpec(
            engine="scaled", cfg=scfg, backend=tcfg["backend"],
            influence_dtype=tcfg["influence_dtype"]))
        o = tcfg["optimizer"]
        opt = optim.adamw(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                          weight_decay=o["weight_decay"])
        self.opt_cfg = o
        self.trainer = OnlineTrainer(
            OnlineTrainerConfig(total_steps=0, update_every=self.k,
                                ckpt_every=int(tcfg["ckpt_every"])),
            self.learner, optim.masked(opt, mtree), ptree, mtree,
            self.stream, device=self.device)
        self.kb_max = 0
        self.check_seconds = 0.0
        self.capture: dict | None = None
        # where set-up goes: the draw (with the device's first use), the
        # learner and trainer, then warm()'s windows
        self.setup_parts = {"draw_s": t1 - t0,
                            "trainer_s": time.perf_counter() - t1}

    # -- set-up ---------------------------------------------------------------

    @contextlib.contextmanager
    def _on_every_step(self, fn):
        """Call fn(new carry) after each of the learner's steps inside."""
        learner = self.learner
        inner = learner.step

        def step(carry, x_t, y_t):
            new, out = inner(carry, x_t, y_t)
            fn(new)
            return new, out

        learner.step = step
        try:
            yield
        finally:
            del learner.step

    def warm(self) -> None:
        """Drive the trainer through its first CHECK_WINDOWS windows and copy
        to the host what the check reads of them."""
        tr = self.trainer
        activity, window_params = [], [_host(self.params0)]
        with self._on_every_step(
                lambda new: activity.append(new["state"]["a"].clone())):
            for w in range(CHECK_WINDOWS):
                t0 = time.perf_counter()
                self.run_units(1)
                self.setup_parts[f"window{w + 1}_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                if w == 0:
                    m1 = _host(flat_leaves(tr.opt_state["m"]))
                window_params.append(
                    _host(flat_leaves(tr.learner.params_of(tr.carry))))
                self.check_seconds += time.perf_counter() - t0
        t0 = time.perf_counter()
        state = tr.carry["state"]
        b1 = self.opt_cfg["b1"]
        self.capture = {
            "activity": torch.stack(activity).cpu(),
            "losses": [w["loss"] for w in tr.windows[:CHECK_WINDOWS]],
            "overflow": [w.get("overflow", 0.0)
                         for w in tr.windows[:CHECK_WINDOWS]],
            "grad1": {k: v / (1.0 - b1) for k, v in m1.items()},
            "window_params": window_params[:CHECK_WINDOWS],
            "params": window_params[CHECK_WINDOWS],
            "vals": state["vals"].cpu(), "idx": state["idx"].cpu()}
        self.check_seconds += time.perf_counter() - t0

    # -- the timed path ---------------------------------------------------------

    def run_units(self, count: int) -> list[dict]:
        """Run `count` more update windows through the trainer's own `run`:
        one record {"ms", "tokens", "failed"} a window, "ms" the trainer's
        own clock from the window's first stream step to its readback."""
        tr = self.trainer
        first = len(tr.windows)
        tr.cfg.total_steps = tr.step + count * self.k
        out = tr.run()
        rs = out.get("row_stats")
        if rs is not None:
            self.kb_max = max(self.kb_max, int(rs["k_max"]))
        recs = []
        for w in tr.windows[first:]:
            over = w.get("overflow", 0.0)
            recs.append({"ms": w["ms"], "tokens": self.batch * self.k,
                         "failed": bool(over > 0 or not math.isfinite(
                             w["loss"]))})
        return recs

    @contextlib.contextmanager
    def traced(self):
        """Inside, keep each step's row indices (a reference, no device
        work); on exit the trace context's row counts are filled."""
        held = [self.trainer.carry["state"]["idx"]]
        ctx = {"kb": [], "kb_prev": []}
        with self._on_every_step(lambda new: held.append(new["state"]["idx"])):
            yield ctx
        kb = [(i >= 0).sum(dim=1).cpu().numpy() for i in held]
        ctx["kb"], ctx["kb_prev"] = kb[1:], kb[:-1]
        ctx["steps"] = len(kb) - 1

    def shapes(self) -> dict:
        """The sizes the per-layer readers count with."""
        vals = self.trainer.carry["state"]["vals"]
        cl = self.learner._cl
        return {"batch": self.batch, "n": self.cfg["n"],
                "n_in": self.cfg["n_in"], "n_out": self.cfg["n_out"],
                "capacity": int(vals.shape[1]), "Pc": int(cl.Pc),
                "Pc_pad": int(vals.shape[2]),
                "carry_dtype_bytes": vals.element_size(),
                "steps_per_unit": self.k}

    def counters(self) -> dict:
        """The program's own counts the per-layer readers may read."""
        return {"carry_alloc_bytes": self.trainer.carry_nbytes()["alloc"],
                "kb_max_sampled": self.kb_max}

    def release(self) -> None:
        """Free the trainer (its carry and temporaries) before the check."""
        del self.trainer, self.learner
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------------

    def reference_inputs(self):
        T = CHECK_WINDOWS * self.k
        xs, ys = generator.stack(self.stream, 0, T)
        return (torch.from_numpy(xs).to(self.device),
                torch.from_numpy(ys).to(self.device))

    def check(self, limits: dict, reference: str) -> list[dict]:
        """The numbers compared, each beside its limit."""
        ref = load_reference(reference)
        xs, ys = self.reference_inputs()
        nums, self.check_info = judge(
            ref, self.capture, self.params0, self.masks, xs, ys, self.cfg,
            k=self.k, delta=limits["v_margin"])
        return with_limits(nums, limits)


def with_limits(nums: dict, limits: dict) -> list[dict]:
    return [{"name": name, "value": value, "limit": limits.get(name)}
            for name, value in nums.items()]


# ---------------------------------------------------------------------------
# The judge
# ---------------------------------------------------------------------------

def follow_reference(ref, params0, masks, xs, ys, cfg, k, capture):
    """The f32 reference over CHECK_WINDOWS windows, following a capture's
    activity and the parameters each of its windows ran from."""
    return ref.run(params0, masks, xs, ys, k=k, windows=CHECK_WINDOWS,
                   opt=cfg["train"]["optimizer"], gamma=cfg["gamma"],
                   eps=cfg["eps"], follow=capture["activity"].to(xs.device),
                   follow_params=capture["window_params"])


def judge(ref, capture: dict, params0: dict, masks: dict, xs, ys, cfg: dict,
          *, k: int, delta: float) -> tuple[dict, dict]:
    """Hold a run's capture against the f32 reference that follows its
    activity and its parameters window by window.  A capture: {"activity"
    [T, B, n], "losses", "grad1", "window_params" (the leaves each window
    ran from), "params" (the leaves after the last update), "vals"
    [B, K, Pc_pad], "idx" [B, K]}.  Returns (the numbers compared, what
    else the reference saw: its largest active-row count, and the largest
    gap between the run's final parameters and its own)."""
    r = follow_reference(ref, params0, masks, xs, ys, cfg, k, capture)
    dev = xs.device
    act = capture["activity"].to(dev)
    wrong = (r["spikes"] != act) & (r["v"].abs() >= delta)
    nums = {"spike_mismatch": float(wrong.sum())}
    nums["loss_gap"] = max(abs(lp - lr) / abs(lr) for lp, lr in
                           zip(capture["losses"], r["losses"]))
    g_ref = {n: float(t.norm()) for n, t in r["grad1"].items()}
    g_run = {n: float(t.norm()) for n, t in capture["grad1"].items()}
    nums["grad_gap"] = leaf_gap(g_run, g_ref)
    moved = {n for n, v in g_ref.items()
             if v >= 1e-3 * statistics.median(g_ref.values())}
    d_ref = {n: float((r["params"][n] - params0[n]).norm()) for n in moved}
    d_run = {n: float((capture["params"][n].to(dev) - params0[n]).norm())
             for n in moved}
    # the median leaf: adamw's step on an entry whose gradient lies within
    # rounding of zero is about lr either way, which moves one leaf's norm
    # by a seed-dependent amount (PERF.md)
    nums["dparam_gap"] = median_leaf_gap(d_run, d_ref)
    nums["carry_gap"] = carry_gap(capture["vals"], capture["idx"],
                                  r["carry"])
    diag = {"kb_max": int(r["kb"].max()),
            "param_maxdiff": {n: float((capture["params"][n].to(dev)
                                        - r["params"][n]).abs().max())
                              for n in r["params"]},
            "dparam_by_leaf": {n: leaf_gap({n: d_run[n]}, {n: d_ref[n]},
                                           statistics.median(d_ref.values()))
                               for n in d_ref}}
    return nums, diag


def leaf_gap(run: dict, ref: dict, med: float | None = None) -> float:
    """The worst leaf's |norm(run) - norm(ref)| over the larger of the
    reference leaf's norm and the median leaf's (`med`, by default the
    median of `ref`)."""
    med = statistics.median(ref.values()) if med is None else med
    return max(abs(run[n] - ref[n]) / max(ref[n], med, 1e-30) for n in ref)


def median_leaf_gap(run: dict, ref: dict) -> float:
    """The median over the leaves of `leaf_gap`'s per-leaf gap."""
    med = statistics.median(ref.values())
    return statistics.median(leaf_gap({n: run[n]}, {n: ref[n]}, med)
                             for n in ref)


def carry_gap(vals, idx, M_ref) -> float:
    """||M_run - M_ref|| / ||M_ref|| over the whole influence, the run's
    compact rows scattered to their units; a run whose live column count
    differs from the reference's reads inf."""
    B, n, Pc = M_ref.shape
    if vals.shape[2] < Pc or bool((vals[:, :, Pc:] != 0).any()):
        return math.inf
    num = den = 0.0
    for b in range(B):
        rows = idx[b].long()
        live = rows >= 0
        dense = torch.zeros((n, Pc), dtype=torch.float32, device=M_ref.device)
        dense[rows[live].to(M_ref.device)] = \
            vals[b, live, :Pc].to(M_ref.device).float()
        num += float((dense - M_ref[b]).double().square().sum())
        den += float(M_ref[b].double().square().sum())
    return math.sqrt(num) / max(math.sqrt(den), 1e-30)


def stand_in_capture(ref, params0, masks, xs, ys, cfg, k, *,
                     precision="f32", fault=None) -> dict:
    """The reference put in the program's place (the control, or a planted
    fault), captured as the program's run is."""
    r = ref.run(params0, masks, xs, ys, k=k, windows=CHECK_WINDOWS,
                opt=cfg["train"]["optimizer"], gamma=cfg["gamma"],
                eps=cfg["eps"], precision=precision, fault=fault)
    B, n = r["carry"].shape[:2]
    idx = torch.arange(n, dtype=torch.int32).expand(B, n).clone()
    cap = {"activity": r["activity"].cpu(), "losses": r["losses"],
           "grad1": _host(r["grad1"]), "params": _host(r["params"]),
           "window_params": [_host(p) for p in r["window_params"]],
           "vals": r["carry"].cpu(), "idx": idx}
    return cap


def build(cfg: dict, mix: dict, seed: int, device) -> ScaledOnline:
    """The system, set up: built and driven through its first windows."""
    s = ScaledOnline(cfg, mix, seed, device)
    s.warm()
    return s
