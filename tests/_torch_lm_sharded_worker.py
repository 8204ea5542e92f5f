"""The ranks of `tests/test_torch_lm_sharded.py`: functions that
`repro_torch.launch.mesh.spawn` runs in each process of a CPU gloo group,
and the one-rank runs the test process holds them against.

This module imports torch, numpy and `repro_torch` only (never `jax` or
`repro`).  The test process writes every case (a config's overrides, the
reference's parameters as numpy, the batches) into one pickle; each rank
runs the sharded steps over its mesh and writes what it saw to
`<out>/rank<r>.pkl`: losses, gradient norms, the gathered parameters and
caches, logits, the Engine's tokens, the collectives it counted, and the
launcher's summaries.
"""
from __future__ import annotations

import hashlib
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import sharding as SH
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ShapeSuite
from repro_torch.launch import mesh as M, steps as ST, train as TRAIN
from repro_torch.models import get_model
from repro_torch.models.module import materialize
from repro_torch.optim import make_optimizer
from repro_torch.runtime.serving import Engine, ServeConfig
from repro_torch.tree import tree_flatten_with_path, tree_map
from repro_torch.weights import params_from_numpy

PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10], [11, 12], [13, 14, 15]]
N_DECODE = 8


def cfg_of(case) -> object:
    return smoke_config(get_config(case["arch"])).replace(**case["kw"])


def _whole(tree):
    """A tree of placed leaves as whole numpy arrays (DTensor's own
    gather: not counted in `sharding.counts`)."""
    return tree_map(lambda x: (x.full_tensor() if SH.is_dtensor(x) else x)
                    .detach().cpu().numpy().copy(), tree)


def opt_of(case):
    """The case's optimizer at its default learning rate."""
    return make_optimizer(case.get("opt", "adamw"))


def _batches(case):
    return [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in case["batches"]]


# ---------------------------------------------------------------------------
# The one-rank port (the test process)
# ---------------------------------------------------------------------------

def train_one(case) -> dict:
    cfg = cfg_of(case)
    params = params_from_numpy(case["params"], "cpu")
    opt = opt_of(case)
    step, state, out = ST.make_train_step(cfg, opt), opt.init(params), []
    for i, b in enumerate(_batches(case)):
        params, state, m = step(params, state, b, i)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": out, "params": _whole(params)}


def _serve_shape(case):
    B, T = case["tokens"].shape
    return ShapeSuite("serve", case["seq"], B, "prefill")


def serve_run(case, mesh=None) -> dict:
    """prefill of the case's prompt into a cache of `seq` slots, then
    N_DECODE decodes of the case's tokens: every step's logits, the caches
    after prefill and at the end (whole), and the collectives of the
    first decode."""
    cfg = cfg_of(case)
    shape = _serve_shape(case)
    dev = "cpu"
    pre = ST.make_prefill_step(cfg, shape, dev, mesh=mesh)
    dec = ST.make_decode_step(cfg, shape, dev, mesh=mesh)
    params = params_from_numpy(case["params"], "cpu")
    if mesh is not None:
        params = SH.place_tree(params, pre.shardings["params"])
    toks = torch.from_numpy(case["tokens"])
    logits, cache = pre.fn(params, {"tokens": toks})
    out = {"logits": [_whole(logits)], "cache": [_whole(cache)]}
    B, T = toks.shape
    for i in range(N_DECODE):
        SH.counts.clear()
        logits, cache = dec.fn(params, torch.from_numpy(case["decode"][i]),
                               cache, torch.full((B,), T + i,
                                                 dtype=torch.long))
        if i == 0:
            out["decode_counts"] = dict(SH.counts)
        out["logits"].append(_whole(logits))
    out["cache"].append(_whole(cache))
    return out


def engine_run(case, mesh=None) -> dict:
    """`generate` greedy and at temperature 0.8 (seed 3), 6 prompts over
    4 slots (slots reused); then slot 0 admitted again: whether every
    cache row of it that this rank holds is zero."""
    cfg = cfg_of(case)
    params = params_from_numpy(case["params"], "cpu")
    out = {"tokens": []}
    for temp in (0.0, 0.8):
        eng = Engine(cfg, ServeConfig(batch_slots=4, max_seq=32,
                                      temperature=temp, seed=3),
                     params, device="cpu", mesh=mesh)
        out["tokens"].append(eng.generate(PROMPTS, max_new=6))
    slot = eng.add_request([1, 2])
    rows = []
    for path, leaf in tree_flatten_with_path(eng.cache):
        ax = eng.batch_axes[path]
        row = slot - (eng.row_lo if mesh is not None else 0)
        if 0 <= row < leaf.shape[ax]:
            rows.append(bool((leaf.select(ax, row) == 0).all()))
    out["slot_zeroed"], out["holds_slot"] = all(rows), bool(rows)
    return out


def one_thread(fn):
    """fn run with torch held to one intra-op thread (then restored)."""
    def wrapped(*a, **k):
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(*a, **k)
        finally:
            torch.set_num_threads(n)
    return wrapped


@one_thread
def digest(arch: str, kw: dict) -> str:
    """sha256 over every output of the one-device steps (mesh=None) of the
    smoke config from torch.Generator(0): 2 train steps (loss, grad norm,
    params, state), a prefill and 2 decodes (logits, caches), in one
    intra-op thread."""
    cfg = smoke_config(get_config(arch)).replace(**kw)
    api = get_model(cfg)
    params = materialize(api.specs(cfg), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    h = hashlib.sha256()

    def feed(tree):
        for _, x in tree_flatten_with_path(tree):
            h.update(x.detach().float().numpy().tobytes())
    opt = ST.default_optimizer(cfg)
    step, state = ST.make_train_step(cfg, opt), opt.init(params)
    for i in range(2):
        b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))),
             "labels": torch.from_numpy(rng.integers(-1, cfg.vocab_size, (2, 16)))}
        params, state, m = step(params, state, b, i)
        feed(m)
    feed(params)
    feed(state)
    shape = ShapeSuite("serve", 24, 2, "prefill")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    logits, cache = ST.make_prefill_step(cfg, shape, "cpu").fn(
        params, {"tokens": toks})
    feed([logits, cache])
    dec = ST.make_decode_step(cfg, shape, "cpu")
    for i in range(2):
        logits, cache = dec.fn(params, toks[:, i:i + 1], cache,
                               torch.full((2,), 16 + i, dtype=torch.long))
        feed([logits, cache])
    return h.hexdigest()


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _train_sharded(case, mesh) -> dict:
    cfg = cfg_of(case)
    opt = opt_of(case)
    B, S = case["batches"][0]["tokens"].shape
    built = ST.make_train_step(cfg, opt, ShapeSuite("t", S, B, "train"),
                               mesh=mesh)
    sh = built.shardings
    params = SH.place_tree(params_from_numpy(case["params"], "cpu"),
                           sh["params"])
    state = ST.init_opt_state(opt, params, sh["opt"])
    out, counts = [], None
    for i, b in enumerate(_batches(case)):
        SH.counts.clear()
        params, state, m = built.fn(params, state, b, i)
        if i == 0:
            counts = dict(SH.counts)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    local = sum(SH.to_local(x).numel() for _, x in
                tree_flatten_with_path(params))
    return {"metrics": out, "params": _whole(params), "counts": counts,
            "pure_dp": sh["pure_dp"], "local_numel": local}


def _refusals(mesh, out_dir) -> dict:
    """The families once refused under a mesh, and adafactor, which still
    is: each build's error (None where it builds), from the step builders,
    the Engine and the launcher (which writes nothing)."""
    shape = ShapeSuite("t", 16, 4, "train")
    out = {}
    for name, cfg, opt in (
            ("moe", smoke_config(get_config("olmoe-1b-7b")), None),
            ("rglru", smoke_config(get_config("recurrentgemma-9b")), None),
            ("encdec", smoke_config(get_config("whisper-large-v3")), None),
            ("adafactor", smoke_config(get_config("qwen3-8b")),
             make_optimizer("adafactor", lr=1e-2))):
        msgs = []
        for build in (lambda: ST.make_train_step(cfg, opt, shape, mesh=mesh),
                      lambda: ST.make_prefill_step(cfg, shape, "cpu",
                                                   mesh=mesh),
                      lambda: Engine(cfg, ServeConfig(), device="cpu",
                                     mesh=mesh)):
            try:
                build()
                msgs.append(None)
            except NotImplementedError as e:
                msgs.append(str(e))
            if name == "adafactor":
                break
        out[name] = msgs
    root = Path(out_dir) / "refused_launch"
    try:
        TRAIN.build_model_lm(TRAIN.parse_args(_launch_argv("olmoe-1b-7b",
                                                           root)), mesh=mesh)
        out["launcher"] = [None]
    except NotImplementedError as e:
        out["launcher"] = [str(e)]
    out["launcher_wrote"] = root.exists()
    return out


def _launcher(argv):
    return TRAIN.main(argv)["summary"]


def _launch_argv(arch, root, *extra):
    return ["--arch", arch, "--smoke", "--device", "cpu", "--steps",
            "6", "--ckpt-every", "2", "--ckpt-dir", str(root), *extra]


def _wait_for(path: Path, timeout: float = 100.0) -> None:
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written")
        time.sleep(0.2)


def mesh_run(rank, world, shape, inp, out):
    """Every sharded case of the pickle at `inp` over a (data, model) mesh
    of `shape`; on (1, 2) also the launcher's crash at step 3 over that
    mesh (the checkpoints that (2, 1) resumes from) and the refusals; on
    (2, 1) the launcher in the group's own host mesh, and the resume."""
    with open(inp, "rb") as f:
        cases = pickle.load(f)
    out = Path(out)
    mesh = M.make_host_mesh(*shape, device="cpu")
    res = {"modules": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "repro"))}
    if shape == (1, 2):
        args = TRAIN.parse_args(_launch_argv("qwen3-8b", out / "ckpt", "--fail-at", "3",
                                             "--steps", "4"))
        run = TRAIN.build_model_lm(args, mesh=mesh)
        from repro_torch.runtime.trainer import run_with_restart
        r = run_with_restart(TRAIN.model_lm_trainers(args, run))
        res["crash"] = {"restarts": r["restarts"],
                        "final_step": r["final_step"]}
        SH.barrier()
        if rank == 0:
            (out / "ckpt_done").touch()
        res["refusals"] = _refusals(mesh, out)
    res["train"] = {k: _train_sharded(c, mesh)
                    for k, c in cases["train"].items()}
    res["serve"] = {k: serve_run(c, mesh) for k, c in cases["serve"].items()}
    res["engine"] = {k: engine_run(c, mesh) for k, c in cases["engine"].items()}
    if shape == (2, 1):
        res["launch"] = _launcher(_launch_argv("gemma2-2b", out / "own"))
        _wait_for(Path(cases["ckpt_from"]) / "ckpt_done")
        res["resume"] = _launcher(_launch_argv("qwen3-8b",
                                               cases["ckpt_from"] + "/ckpt"))
        try:
            TRAIN.main(_launch_argv("gemma2-2b", out / "prod",
                                    "--production-mesh"))
            res["production"] = None
        except ValueError as e:
            res["production"] = str(e)
    with open(out / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
