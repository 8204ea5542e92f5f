"""The ranks of `tests/test_torch_sharded.py`: functions that
`repro_torch.launch.mesh.spawn` runs in each process of a CPU gloo group.

This module imports torch, numpy and `repro_torch` only (never `jax` or
`repro`), so a spawned rank starts without the JAX package.  The test
process hands every rank its inputs (the reference's parameters, masks
and streams, as numpy) in one pickle it wrote itself, and each rank writes
its results to `<out>/rank<r>.pkl` for the test process to hold against
the reference.
"""
from __future__ import annotations

import pickle
import sys
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch import sharding as SH
from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import cells as C, scaled_rtrl as SC, sparse_rtrl as SP
from repro_torch.core.learner import LearnerSpec, make_learner
from repro_torch.data.pipeline import ShardedHostLoader
from repro_torch.kernels import compact_fused as CF
from repro_torch.launch import mesh as M
from repro_torch.models import moe as MO
from repro_torch.models.module import NamedSharding, materialize, tree_shardings
from repro_torch.optim import optimizers as O
from repro_torch.runtime import compression as CMP, online as ON
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.sparsity import migrate_influence, migrate_sharded, migration_plan
from repro_torch.tree import tree_map
from repro_torch.weights import masks_from_numpy, params_from_numpy, to_numpy


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


# the plain K1 (the CPU's version of the kernel), counted with the widths
# of the column shards it ran on
K1_WIDTHS: list = []
_plain_k1 = CF.fused_reference


def _counted_k1(*args, **kw):
    K1_WIDTHS.append(int(args[1].shape[-1]))
    return _plain_k1(*args, **kw)


CF.fused_reference = _counted_k1


# ---------------------------------------------------------------------------
# The scaled engine on a sharded carry
# ---------------------------------------------------------------------------

def _problem(case):
    cfg = SC.ScaledRTRLConfig(**case["cfg"])
    tp = params_from_numpy(case["params"], "cpu")
    tm = ([masks_from_numpy(m, "cpu") for m in case["masks"]]
          if cfg.n_layers > 1 else masks_from_numpy(case["masks"], "cpu"))
    return (cfg, tp, tm, torch.from_numpy(case["xs"]),
            torch.from_numpy(case["labels"]))


def _scaled(mesh, case, backend, col):
    """T steps of the one-rank learner and of the sharded one, the sharded
    grads, the collectives counted in the steps and in grads."""
    cfg, tp, tm, xs, labels = _problem(case)
    T = xs.shape[0]
    spec = LearnerSpec(engine="scaled", cfg=cfg, backend=backend,
                       col_compact=col)
    one = make_learner(spec)
    c1 = one.init(tp, tm, (xs[0], labels), t_total=T)
    for t in range(T):
        c1, _ = one.step(c1, xs[t], labels)
    lr = make_learner(spec)
    c2 = lr.place(lr.init(tp, tm, (xs[0], labels), t_total=T), mesh)
    del K1_WIDTHS[:]
    with CommDebugMode() as steps:
        for t in range(T):
            c2, _ = lr.step(c2, xs[t], labels)
    widths = list(K1_WIDTHS)
    SH.counts.clear()
    with CommDebugMode() as upd:
        g2 = lr.grads(c2)
    grad_colls = dict(SH.counts)
    full = lr.gather(c2)
    return {"one": {"state": to_numpy(c1["state"]),
                    "grads": to_numpy(one.grads(c1)),
                    "loss": float(c1["loss"])},
            "sharded": {"state": to_numpy(full["state"]),
                        "grads": to_numpy(g2), "loss": float(full["loss"])},
            "local_vals": tuple(SH.to_local(
                c2["state"]["vals"][0] if cfg.n_layers > 1
                else c2["state"]["vals"]).shape),
            "steps_comm": steps.get_total_counts(),
            "update_comm": upd.get_total_counts(), "grad_colls": grad_colls,
            "k1_widths": widths}, (lr, c2)


def _migration(mesh, case):
    """The learner's RigL event on a sharded carry against the same event
    on one rank, and migrate_sharded against migrate_influence on the
    case's own new masks."""
    cfg, tp, tm, xs, labels = _problem(case)
    T = xs.shape[0]
    spec = LearnerSpec(engine="scaled", cfg=cfg, backend="compact",
                       rewirable=True)
    key = (0, 7, 0)
    one = make_learner(spec)
    c1 = one.init(tp, tm, (xs[0], labels), t_total=T)
    lr = make_learner(spec)
    c2 = lr.place(lr.init(tp, tm, (xs[0], labels), t_total=T), mesh)
    for t in range(T // 2):
        c1, _ = one.step(c1, xs[t], labels)
        c2, _ = lr.step(c2, xs[t], labels)
    c1 = one.rewire(c1, key, frac=0.2)
    SH.counts.clear()
    c2 = lr.rewire(c2, key, frac=0.2)
    event_colls = dict(SH.counts)
    after = lr.gather(c2)
    out = {"event_colls": event_colls,
           "vals_one": to_numpy(c1["state"]["vals"]),
           "vals_sharded": to_numpy(after["state"]["vals"]),
           "gw_one": to_numpy(c1["gw"]), "gw_sharded": to_numpy(after["gw"])}
    for t in range(T // 2, T):
        c1, _ = one.step(c1, xs[t], labels)
        c2, _ = lr.step(c2, xs[t], labels)
    out["grads_one"] = to_numpy(one.grads(c1))
    out["grads_sharded"] = to_numpy(lr.grads(c2))
    # migrate_sharded on the case's masks, at the carry's columns
    old_cl = cfg.col_layout(tm, device="cpu")
    new_m = masks_from_numpy(case["new_masks"], "cpu")
    new_cl = cfg.col_layout(new_m, device="cpu")
    plan = migration_plan(old_cl, new_cl)
    vals = torch.from_numpy(case["vals"])
    n_model = mesh["model"].size()
    w = vals.shape[-1] // n_model
    c0 = mesh.get_coordinate()[mesh.mesh_dim_names.index("model")] * w
    mine = migrate_sharded(plan, [vals[..., c0:c0 + w].contiguous()], mesh,
                           c0)[0]
    out["migrated_local"] = mine.numpy()
    out["migrated_whole"] = migrate_influence(old_cl, new_cl, vals,
                                              plan)[..., c0:c0 + w].numpy()
    return out


def _carry_like(case, backend):
    cfg, tp, tm, xs, labels = _problem(case)
    lr = make_learner(LearnerSpec(engine="scaled", cfg=cfg, backend=backend))
    return lr, lr.init(tp, tm, (xs[0], labels), t_total=xs.shape[0])


def _continue(lr, carry, case, steps):
    _, _, _, xs, labels = _problem(case)
    for t in range(steps):
        carry, _ = lr.step(carry, xs[t], labels)
    return carry


# ---------------------------------------------------------------------------
# Compression, the loader, the MoE block, the trainers
# ---------------------------------------------------------------------------

def _compression(rank):
    """compressed_psum over a 2-rank 'pod' dim: the reference's
    error-feedback case (the same g on every rank) and one with a
    different g a rank."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    base = torch.linspace(-1.0, 1.0, 64).reshape(8, 8)
    out = {}
    for name, g in (("same", base), ("ranked", base * (1.0 + rank))):
        grads = {"w": g}
        err = CMP.init_error_state(grads)
        total = torch.zeros(8, 8)
        SH.counts.clear()
        for _ in range(8):
            g_hat, err = CMP.compressed_psum(grads, err, mesh)
            total = total + g_hat["w"]
        out[name] = {"total": total.numpy(), "colls": dict(SH.counts)}
    return out


def _loader(mesh):
    """Order and placement of every batch, a loader failure raised to the
    consumer, and close()."""
    sh = {"x": NamedSharding(mesh, ("data", None)),
          "y": NamedSharding(mesh, ())}
    batches = [{"x": np.arange(16, dtype=np.float32).reshape(4, 4) + 100 * i,
                "y": np.full((4,), i, np.int32)} for i in range(5)]
    got = []
    ld = ShardedHostLoader(iter(batches), sh, prefetch=2)
    for b in ld:
        got.append({"x": SH.to_local(b["x"]).numpy(),
                    "x_placements": str(getattr(b["x"], "placements", None)),
                    "y": b["y"].numpy(), "y_dtensor": SH.is_dtensor(b["y"])})
    ld.close()

    def failing():
        yield batches[0]
        raise RuntimeError("loader failure at batch 1")

    ld = ShardedHostLoader(failing(), sh)
    first = SH.to_local(next(ld)["x"]).numpy()
    try:
        next(ld)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    ld.close()

    def endless():
        i = 0
        while True:
            yield batches[i % 5]
            i += 1

    ld = ShardedHostLoader(endless(), sh, prefetch=2)
    next(ld)
    ld.close()
    return {"batches": got, "first": first, "raised": raised,
            "closed": not ld._thread.is_alive()}


def _moe(mesh, arch, fsdp):
    cfg = smoke_config(get_config(arch)).replace(moe_impl="shardmap",
                                                 fsdp=fsdp)
    p = materialize(MO.moe_specs(cfg), torch.Generator().manual_seed(0))
    x = torch.randn(4, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(
        cfg.compute_dtype)
    y_disp, aux_disp = MO.moe_block(cfg.replace(moe_impl="dispatch"), p, x)
    psh = tree_shardings(MO.moe_specs(cfg), SH.make_rules(cfg, mesh), mesh)
    placed = {k: SH.place(v, psh[k]) for k, v in p.items()}
    xsh = NamedSharding(mesh, (SH.batch_axes(mesh), None, None))
    ctx = SH.make_ctx(cfg, mesh)
    SH.counts.clear()
    y, aux = MO.moe_block(cfg, placed, SH.place(x, xsh), ctx)
    colls = dict(SH.counts)
    y2, aux2 = MO.moe_block(cfg, placed, SH.place(x, xsh), ctx)
    rows = SH.local_index(x.shape, xsh.placements, mesh.get_coordinate(),
                          mesh.shape)
    # the tokens of this batch shard through the one-rank dispatch
    y_shard, aux_shard = MO.moe_block(cfg.replace(moe_impl="dispatch"), p,
                                      x[rows])
    return {"y": y.to_local().float().numpy(),
            "y_disp_rows": y_disp[rows].float().numpy(),
            "y_shard_disp": y_shard.float().numpy(),
            "aux": float(aux), "aux_disp": float(aux_disp),
            "aux_shard": float(aux_shard),
            "bitwise": bool(torch.equal(y.to_local(), y2.to_local())
                            and torch.equal(aux, aux2)),
            "colls": colls,
            "placements": {k: str(getattr(v, "placements", "whole"))
                           for k, v in placed.items()}}


def _constraint(mesh):
    """logical_constraint: a plain tensor (this rank's local value) stays
    as it is; a DTensor is redistributed to the rules' placements; no mesh,
    nothing."""
    from repro_torch.models.module import ShardingRules, logical_constraint
    rules = ShardingRules({"batch": "data", "mlp": "model"})
    whole = torch.arange(32.0).reshape(4, 8)
    plain = logical_constraint(whole, ("batch", "mlp"), rules, mesh)
    dt = SH.place(whole, NamedSharding(mesh, ("data", None)))
    moved = logical_constraint(dt, ("batch", "mlp"), rules, mesh)
    return {"plain_same": plain is whole,
            "no_mesh_same": logical_constraint(dt, ("batch", "mlp"), rules,
                                               None) is dt,
            "before": str(dt.placements), "after": str(moved.placements),
            "local": moved.to_local().numpy()}


def _egru_trainer(root, total, ckpt_every):
    """A small online EGRU trainer drawn from a seed (port only)."""
    cfg = C.EGRUConfig(n_hidden=8, n_in=3, n_out=2, kind="gru")
    gen = torch.Generator().manual_seed(0)
    params = C.init_params(cfg, gen, device="cpu")
    masks = SP.make_masks(cfg, gen, 0.5, device="cpu")
    params = SP.apply_masks(params, masks)
    learner = make_learner(LearnerSpec(engine="sparse", cfg=cfg,
                                       backend="compact"))
    opt = O.masked(O.make_optimizer("adamw", lr=1e-2), dict(masks))

    def stream(t):
        rng = np.random.default_rng(1000 + t)
        return (rng.standard_normal((2, 3)).astype(np.float32),
                (np.arange(2) % 2).astype(np.int32))

    ocfg = ON.OnlineTrainerConfig(total_steps=total, update_every=3,
                                  ckpt_every=ckpt_every, ckpt_dir=str(root),
                                  log_every=1)
    return ON.OnlineTrainer(ocfg, learner, opt, params, masks, stream,
                            device="cpu")


def _trainers(mesh, out_dir, rank):
    """The reference's elastic re-mesh resumes (test_guard.py:373,
    test_checkpoint.py:46) onto this mesh."""
    res = {}
    root = Path(out_dir) / "online"
    a = _egru_trainer(root, 30, 2)
    a.run()
    clean = _egru_trainer(Path(out_dir) / f"clean{rank}", 48, 0)
    clean.run()
    b = _egru_trainer(root, 48, 2)
    b.shardings = tree_map(lambda _: NamedSharding(mesh, ()), b._ckpt_tree())
    res["resumed"] = b.try_resume()
    res["step_update"] = (b.step, b.update)
    res["on_mesh"] = all(isinstance(x, torch.Tensor)
                         and x.device.type == mesh.device_type
                         for x in _tensor_leaves(b.carry))
    b.run()
    res["bitwise"] = all(torch.equal(x, y) for x, y in zip(
        _tensor_leaves(clean.carry), _tensor_leaves(b.carry)))
    # Trainer: params and opt state resumed onto target shardings, a
    # parameter sharded over 'data'
    opt = O.make_optimizer("adamw", lr=1e-2)
    params = {"w": torch.arange(16.0).reshape(4, 4)}
    cm = CheckpointManager(Path(out_dir) / "trainer", async_write=False)
    cm.save(3, {"params": params, "opt": opt.init(params)})
    p_sh = {"w": NamedSharding(mesh, ("data", None))}
    o_sh = tree_map(lambda _: NamedSharding(mesh, ()), opt.init(params))
    t = Trainer(TrainerConfig(ckpt_dir=str(Path(out_dir) / "trainer")),
                None, {"w": torch.zeros(4, 4)}, opt.init(params), None,
                shardings=(p_sh, o_sh))
    res["trainer_resumed"] = t.try_resume() and t.step == 3
    w = t.params["w"]
    res["trainer_w"] = (str(w.placements), SH.to_local(w).numpy())
    return res


def _tensor_leaves(tree):
    from repro_torch.tree import tree_leaves
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _write(out_dir, rank, res):
    res["jax_imported"] = sorted(m for m in sys.modules
                                 if m == "jax" or m.startswith("jax.")
                                 or m == "repro" or m.startswith("repro."))
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def mesh_1x2(rank, world, inp_path, out_dir):
    """Mesh (1, 2): the scaled step (L = 1, 2; both backends; a full-width
    carry), the RigL event, the sharded checkpoint, compression, the
    loader and the MoE block."""
    inp = _load(inp_path)
    mesh = M.make_host_mesh(1, 2, device="cpu")
    res = {"scaled": {}}
    carry_for_ckpt = None
    for L in (1, 2):
        for backend in ("compact", "compact_fused"):
            r, lc = _scaled(mesh, inp["scaled"][L], backend, None)
            res["scaled"][(L, backend, None)] = r
            if (L, backend) == (1, "compact_fused"):
                carry_for_ckpt = lc
    res["scaled"][(1, "compact", False)] = _scaled(
        mesh, inp["scaled"][1], "compact", False)[0]
    res["migration"] = _migration(mesh, inp["scaled"][1])
    lr, c2 = carry_for_ckpt
    save_checkpoint(Path(out_dir) / "ckpt", 1, {"carry": c2})
    res["ckpt_gathered"] = to_numpy(tree_map(
        lambda x: x, {k: v for k, v in lr.gather(c2).items() if k != "rw"}))
    res["compression"] = _compression(rank)
    res["loader"] = _loader(mesh)
    res["constraint"] = _constraint(mesh)
    res["moe"] = {arch: _moe(mesh, arch, False)
                  for arch in ("olmoe-1b-7b", "kimi-k2-1t-a32b")}
    _write(out_dir, rank, res)


def mesh_2x2(rank, world, inp_path, out_dir):
    """Mesh (2, 2): the scaled step (L = 1, 2; both backends), the
    sharded migration, and the MoE block with fsdp on (the all_gather of
    the expert weights over 'data')."""
    inp = _load(inp_path)
    mesh = M.make_host_mesh(2, 2, device="cpu")
    res = {"scaled": {}}
    for L in (1, 2):
        for backend in ("compact", "compact_fused"):
            res["scaled"][(L, backend, None)] = _scaled(
                mesh, inp["scaled"][L], backend, None)[0]
    res["migration"] = _migration(mesh, inp["scaled"][1])
    res["moe"] = {arch: _moe(mesh, arch, True)
                  for arch in ("olmoe-1b-7b", "kimi-k2-1t-a32b")}
    # the batch axes of a pod mesh: one group over ('pod', 'data')
    from torch.distributed.device_mesh import init_device_mesh
    pod = init_device_mesh("cpu", (2, 2, 1),
                           mesh_dim_names=("pod", "data", "model"))
    res["pod_data_sum"] = float(SH.all_reduce(
        torch.tensor([float(rank + 1)]), pod, ("pod", "data"))[0])
    res["pod_data_rows"] = SH.all_gather(torch.tensor([rank]), pod,
                                        ("pod", "data")).tolist()
    _write(out_dir, rank, res)


def mesh_2x1(rank, world, inp_path, out_dir):
    """Mesh (2, 1): the (1, 2)-written checkpoint restored onto this mesh
    and stepped on, and the trainers' re-mesh resumes."""
    inp = _load(inp_path)
    mesh = M.make_host_mesh(2, 1, device="cpu")
    case = inp["scaled"][1]
    res = {}
    lr, like = _carry_like(case, "compact_fused")
    one, one_like = _carry_like(case, "compact_fused")
    ckpt = Path(inp["ckpt_dir"])
    restored, step = load_checkpoint(ckpt, {"carry": like},
                                     {"carry": lr.shardings(like, mesh)})
    res["placements"] = {k: str(getattr(v, "placements", "whole"))
                         for k, v in restored["carry"]["state"].items()}
    whole, _ = load_checkpoint(ckpt, {"carry": one_like})
    c2 = _continue(lr, restored["carry"], case, 4)
    c1 = _continue(one, whole["carry"], case, 4)
    res["continued_one"] = {"state": to_numpy(c1["state"]),
                            "grads": to_numpy(one.grads(c1))}
    res["continued_sharded"] = {"state": to_numpy(lr.gather(c2)["state"]),
                                "grads": to_numpy(lr.grads(c2))}
    res["trainers"] = _trainers(mesh, out_dir, rank)
    _write(out_dir, rank, res)
