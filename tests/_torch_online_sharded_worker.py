"""The ranks of `tests/test_torch_online_sharded.py`: functions that
`repro_torch.launch.mesh.spawn` runs in each process of a CPU gloo group,
each driving `runtime.online.OnlineTrainer` over a scaled carry placed on
the group's mesh (`ScaledLearner.place`).

This module imports torch, numpy and `repro_torch` only (never `jax` or
`repro`), so a spawned rank starts without the JAX package.  The test
process hands every rank the reference's parameters, masks and stream (as
numpy) in one pickle, and each rank writes the whole values its trainers
end with (gathered) to `<out>/rank<r>.pkl`.  `trainer` and `summary` are
shared with the test process, which runs the same trainers on one device.
"""
from __future__ import annotations

import pickle
import shutil
import sys
from pathlib import Path

from repro_torch import sharding as SH
from repro_torch.core import scaled_rtrl as SC
from repro_torch.core.learner import LearnerSpec, make_learner
from repro_torch.kernels import compact_fused as CF
from repro_torch.launch import mesh as M
from repro_torch.obs import MetricPack, Telemetry
from repro_torch.optim import optimizers as O
from repro_torch.runtime import guard as G, online as ON
from repro_torch.runtime.trainer import InjectedFailure
from repro_torch.sparsity import RewireSchedule
from repro_torch.weights import masks_from_numpy, params_from_numpy, to_numpy

K = 4                  # stream steps an update
WINDOWS = 4
CORRUPT_AT = 2         # the guard case: rank 1's rows poisoned after update 2
CRASH_AT = 3           # the crash cases: a checkpoint every 2 updates
REWIRE_EVERY = 3       # one RigL event, after update 3

# the plain K1 (the CPU's version of the kernel), counted with the widths
# of the column shards it ran on, and every window's packed telemetry
# vector as `MetricPack.unpack` reads it back (one call a window is THE
# readback): the ranks' instruments (`_instrument`)
K1_WIDTHS: list = []
UNPACKED: list = []


def _instrument():
    plain_k1, unpack = CF.fused_reference, MetricPack.unpack

    def counted_k1(*args, **kw):
        K1_WIDTHS.append(int(args[1].shape[-1]))
        return plain_k1(*args, **kw)

    def counted_unpack(self, vec):
        out = unpack(self, vec)
        UNPACKED.append(out)
        return out
    CF.fused_reference = counted_k1
    MetricPack.unpack = counted_unpack


class RankCorruption:
    """A fault plan that poisons one element of `rank`'s local influence
    shard after update `at` (the other ranks' shards stay clean)."""
    fail_ckpt_writes = 0

    def __init__(self, at: int, rank: int):
        self.at, self.rank, self.done = at, rank, False

    def wrap_stream(self, stream):
        return stream

    def maybe_crash(self, update):
        pass

    def maybe_corrupt(self, trainer):
        if trainer.update != self.at or self.done:
            return
        self.done = True
        import torch.distributed as dist
        if dist.get_rank() != self.rank:
            return
        from torch.distributed.tensor import DTensor
        vals = trainer.carry["state"]["vals"]
        local = vals.to_local().clone()
        local[0, 0, 0] = float("nan")
        carry = dict(trainer.carry)
        carry["state"] = dict(carry["state"])
        carry["state"]["vals"] = DTensor.from_local(
            local, vals.device_mesh, vals.placements, run_check=False,
            shape=vals.shape, stride=vals.stride())
        trainer.carry = carry


def trainer(case, root, *, mesh=None, backend="compact_fused", fail_at=-1,
            ckpt_every=0, guard=None, fault_plan=None, rewire=False,
            telemetry=None, grads_out=None):
    """An OnlineTrainer of the scaled learner on the case's parameters,
    masks and stream: masked adamw, an update every K steps, WINDOWS
    windows; its carry placed on `mesh` (and restores placed by the
    learner's target shardings) when one is given.  `grads_out` collects
    every window's gradients as the optimizer receives them."""
    cfg = SC.ScaledRTRLConfig(**case["cfg"])
    tp = params_from_numpy(case["params"], "cpu")
    tm = masks_from_numpy(case["masks"], "cpu")
    spec = (LearnerSpec(engine="scaled", cfg=cfg, backend="compact",
                        col_compact=True, rewirable=True) if rewire else
            LearnerSpec(engine="scaled", cfg=cfg, backend=backend))
    learner = make_learner(spec)
    base = O.adamw(lr=1e-2)
    opt = (O.masked_dynamic(base, {**tm, "out": None}) if rewire
           else O.masked(base, {**tm, "out": None}))
    if grads_out is not None:
        inner = opt

        def update(grads, state, params, step):
            grads_out.append(to_numpy(grads))
            return inner.update(grads, state, params, step)
        opt = O.Optimizer(inner.init, update)
    xs, ys = case["xs"], case["ys"]
    tr = ON.OnlineTrainer(
        ON.OnlineTrainerConfig(total_steps=K * WINDOWS, update_every=K,
                               ckpt_every=ckpt_every, ckpt_dir=str(root),
                               fail_at_update=fail_at, log_every=1),
        learner, opt, tp, tm, lambda t: (xs[t], ys[t]), device="cpu",
        rewire_schedule=(RewireSchedule("rigl", every_k=REWIRE_EVERY,
                                        frac=0.3, block=cfg.mask_block)
                         if rewire else None),
        guard=guard, fault_plan=fault_plan, telemetry=telemetry)
    if mesh is not None:
        tr.carry = learner.place(tr.carry, mesh)
        tr.shardings = {"carry": learner.shardings(tr.carry, mesh)}
    return tr


def summary(tr, out) -> dict:
    """The whole values a run ends with (a sharded carry gathered), as
    numpy: the windows' host metrics, the carry's state and parameters,
    the optimizer state, row stats and carry bytes."""
    carry = tr.learner.gather(tr.carry)
    return {"windows": [{k: v for k, v in w.items() if k != "ms"}
                        for w in tr.windows],
            "state": to_numpy(carry["state"]),
            "params": to_numpy(carry["params"]),
            "opt": to_numpy(tr.opt_state),
            "masks": to_numpy(carry["rw"]["masks"]) if "rw" in carry else None,
            "row_stats": out["row_stats"],
            "carry_bytes": out["carry_bytes"],
            "carry_live_bytes": out["carry_live_bytes"],
            "updates": out["updates"], "final_step": out["final_step"],
            "rewire_events": out["rewire_events"]}


def _crash_and_resume(case, mesh, root):
    """A run that crashes before update CRASH_AT + 1 (a checkpoint every 2
    updates), then a new trainer on the same mesh resumed from it."""
    a = trainer(case, root, mesh=mesh, fail_at=CRASH_AT, ckpt_every=2)
    try:
        a.run()
        raise AssertionError("the injected failure did not fire")
    except InjectedFailure:
        pass
    b = trainer(case, root, mesh=mesh, ckpt_every=2)
    resumed = b.try_resume()
    at = (b.step, b.update)
    res = summary(b, b.run())
    res["resumed"], res["resumed_at"] = resumed, at
    return res


def _run_all(rank, mesh, inp, out_dir):
    _instrument()
    case = inp["case"]
    out_dir = Path(out_dir)
    res = {}
    # the windows, their gradients and K1's widths
    grads: list = []
    K1_WIDTHS.clear()
    tr = trainer(case, out_dir / "base", mesh=mesh, grads_out=grads)
    SH.counts.clear()
    res["base"] = summary(tr, tr.run())
    res["base"]["grads"] = grads
    res["k1_widths"] = list(K1_WIDTHS)
    res["local_vals"] = tuple(SH.to_local(tr.carry["state"]["vals"]).shape)
    # crash and resume on this mesh
    res["crash"] = _crash_and_resume(case, mesh, out_dir / "crash")
    # the guard: rank 1's shard poisoned after update CORRUPT_AT
    # overflow_streak off: capacity 0.5 overflows every window by design
    gcfg = G.GuardConfig(ring=2, policy="full", overflow_streak=0)
    tr = trainer(case, out_dir / "guard", mesh=mesh, guard=gcfg,
                 fault_plan=RankCorruption(CORRUPT_AT, 1))
    res["guard"] = summary(tr, tr.run())
    res["guard"]["report"] = tr.guard.report()
    # one RigL event
    tr = trainer(case, out_dir / "rewire", mesh=mesh, rewire=True)
    SH.counts.clear()
    res["rewire"] = summary(tr, tr.run())
    # telemetry: the packed vector, read back once a window
    UNPACKED.clear()
    tel = Telemetry.create(out_dir / f"telemetry{rank}")
    tr = trainer(case, out_dir / "telemetry", mesh=mesh, telemetry=tel)
    res["telemetry"] = summary(tr, tr.run())
    res["telemetry"]["unpacked"] = list(UNPACKED)
    return res


def _write(out_dir, rank, res):
    res["jax_imported"] = sorted(m for m in sys.modules
                                 if m == "jax" or m.startswith("jax.")
                                 or m == "repro" or m.startswith("repro."))
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def mesh_1x2(rank, world, inp_path, out_dir):
    """Mesh (1, 2), and a run crashed after writing its checkpoint at
    update 2, for the (2, 1) group to resume."""
    inp = _load(inp_path)
    mesh = M.make_host_mesh(1, 2, device="cpu")
    res = _run_all(rank, mesh, inp, out_dir)
    a = trainer(inp["case"], Path(out_dir) / "to_2x1", mesh=mesh,
                fail_at=CRASH_AT, ckpt_every=2)
    try:
        a.run()
    except InjectedFailure:
        pass
    _write(out_dir, rank, res)


def mesh_2x2(rank, world, inp_path, out_dir):
    inp = _load(inp_path)
    _write(out_dir, rank, _run_all(rank, M.make_host_mesh(2, 2, device="cpu"),
                                   inp, out_dir))


def mesh_2x1(rank, world, inp_path, out_dir):
    """Mesh (2, 1), and the (1, 2) group's checkpoint resumed here."""
    inp = _load(inp_path)
    mesh = M.make_host_mesh(2, 1, device="cpu")
    res = _run_all(rank, mesh, inp, out_dir)
    root = Path(out_dir) / "from_1x2"
    if rank == 0:
        shutil.copytree(inp["ckpt_dir"], root)
    SH.barrier()
    b = trainer(inp["case"], root, mesh=mesh, ckpt_every=2)
    resumed = b.try_resume()
    at = (b.step, b.update)
    res["remesh"] = summary(b, b.run())
    res["remesh"]["resumed"], res["remesh"]["resumed_at"] = resumed, at
    res["remesh"]["placements"] = str(b.carry["state"]["vals"].placements)
    _write(out_dir, rank, res)
