"""The ranks of `tests/test_torch_families_sharded.py`: functions that
`repro_torch.launch.mesh.spawn` runs in each process of a CPU gloo group,
and the one-rank runs the test process holds them against, for the MoE
decoders, the RG-LRU LM and the encoder-decoder.

This module imports torch, numpy and `repro_torch` only (never `jax` or
`repro`), and reuses the dense families' worker
(`_torch_lm_sharded_worker`) where a case needs nothing more.  The test
process writes every case into one pickle; each rank runs the sharded
steps over its mesh and writes what it saw to `<out>/rank<r>.pkl`.

The MoE block's mesh form follows the reference's semantics
(`models.moe`): with the batch split into D data blocks its shardmap form
dispatches each block alone at capacity C(T / D) and averages the blocks'
aux losses.  `moe_blocks(D)` runs those semantics on one rank, block by
block, so the one-rank port is the oracle of the sharded one at any D.
"""
from __future__ import annotations

import contextlib
import hashlib
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

import _torch_lm_sharded_worker as LW
from repro_torch import sharding as SH
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ShapeSuite
from repro_torch.launch import mesh as M, steps as ST, train as TRAIN
from repro_torch.models import get_model, moe as MO, transformer as TR
from repro_torch.models.module import NULL_CTX, materialize
from repro_torch.tree import tree_flatten_with_path
from repro_torch.weights import params_from_numpy

cfg_of, one_thread, whole = LW.cfg_of, LW.one_thread, LW._whole


# ---------------------------------------------------------------------------
# One-rank oracles
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def moe_blocks(D: int, drops: list | None = None):
    """Within the block, `models.moe.moe_block` on one rank takes the
    reference's shardmap semantics at D data blocks: where the batch rows
    split into D blocks of at least one token an expert, each block is
    dispatched alone (C(T / D)) and the aux loss is the blocks' mean; else
    the global dispatch.  `drops` (a list) collects each dispatch's dropped
    pairs: the pairs past C in each expert's queue."""
    orig, orig_dispatch = MO.moe_block, MO._dispatch

    def blocks(cfg, p, x, ctx=NULL_CTX):
        B, S, _ = x.shape
        b = B // D
        if (D == 1 or B % D or b * S < cfg.n_experts
                or cfg.moe_impl not in ("shardmap", "blockwise")):
            return orig(cfg, p, x, ctx)
        outs = [orig(cfg, p, x[i * b:(i + 1) * b], ctx) for i in range(D)]
        return torch.cat([y for y, _ in outs]), _mean([a for _, a in outs])

    def counted(cfg, p, xt, gate, expert_idx, C, e0=0, E_loc=None,
                offset=None):
        # this call's pairs hold places [off, off + n) of expert e's queue
        n = MO.expert_counts(expert_idx, cfg.n_experts)
        off = torch.zeros_like(n) if offset is None else offset
        past = (off + n - C).clamp(min=0) - (off - C).clamp(min=0)
        drops.append(int(past.sum()))
        return orig_dispatch(cfg, p, xt, gate, expert_idx, C, e0, E_loc,
                             offset)

    MO.moe_block = blocks
    if drops is not None:
        MO._dispatch = counted
    try:
        yield
    finally:
        MO.moe_block, MO._dispatch = orig, orig_dispatch


def _mean(xs):
    """(x0 + x1 + ...) / n in the order the ranks' all_reduce sums two."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out / len(xs)


@contextlib.contextmanager
def aux_only():
    """The decoders' loss is 0.01 x the MoE aux loss alone (the cross
    entropy weighted 0)."""
    orig = TR.chunked_ce_loss
    TR.chunked_ce_loss = lambda cfg, params, h, labels, **k: h.sum() * 0.0
    try:
        yield
    finally:
        TR.chunked_ce_loss = orig


def train_one(case, D: int = 1) -> dict:
    """The case's steps on one rank, at D data blocks' MoE semantics."""
    drops: list = []
    with moe_blocks(D, drops), (aux_only() if case.get("aux_only")
                                else contextlib.nullcontext()):
        out = LW.train_one(case)
    out["drops"] = sum(drops)
    return out


def train_sharded(case, mesh) -> dict:
    with (aux_only() if case.get("aux_only") else contextlib.nullcontext()):
        return LW._train_sharded(case, mesh)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def serve_run(case, mesh=None, D: int = 1) -> dict:
    """prefill of the case's prompt (and frames) into a cache of `seq`
    slots, then its decodes: every step's logits, the caches after
    prefill and at the end (whole), the collectives of the first decode,
    and the pairs the MoE dispatches dropped (a rank's: of its own
    tokens)."""
    cfg = cfg_of(case)
    B, T = case["tokens"].shape
    shape = ShapeSuite("serve", case["seq"], B, "prefill")
    pre = ST.make_prefill_step(cfg, shape, "cpu", mesh=mesh)
    dec = ST.make_decode_step(cfg, shape, "cpu", mesh=mesh)
    params = params_from_numpy(case["params"], "cpu")
    if mesh is not None:
        params = SH.place_tree(params, pre.shardings["params"])
    batch = {"tokens": torch.from_numpy(case["tokens"])}
    if "frames" in case:
        batch["frames"] = torch.from_numpy(case["frames"])
    drops: list = []
    with moe_blocks(D, drops):
        logits, cache = pre.fn(params, batch)
        out = {"logits": [whole(logits)], "cache": [whole(cache)]}
        for i, tok in enumerate(case["decode"]):
            SH.counts.clear()
            logits, cache = dec.fn(params, torch.from_numpy(tok), cache,
                                   torch.full((B,), T + i, dtype=torch.long))
            if i == 0:
                out["decode_counts"] = dict(SH.counts)
            out["logits"].append(whole(logits))
    out["cache"].append(whole(cache))
    out["drops"] = sum(drops)
    return out


def route_layer0(case) -> np.ndarray:
    """The experts [V, k] that layer 0 routes each vocabulary token to, as
    the first token of a prompt (one rank)."""
    cfg = cfg_of(case)
    params = params_from_numpy(case["params"], "cpu")
    seen = []
    orig = MO._top_k

    def record(cfg_, probs):
        out = orig(cfg_, probs)
        seen.append(out[1])
        return out
    MO._top_k = record
    try:
        with torch.no_grad():
            get_model(cfg).prefill(cfg, params, torch.arange(
                cfg.vocab_size)[:, None])
    finally:
        MO._top_k = orig
    return seen[0].numpy()


# ---------------------------------------------------------------------------
# mesh=None
# ---------------------------------------------------------------------------

@one_thread
def digest(arch: str, kw: dict) -> str:
    """sha256 over every output of the one-device steps (mesh=None) of the
    smoke config from torch.Generator(0): 2 train steps (loss, grad norm,
    params, state), a prefill and 2 decodes (logits, caches), in one
    intra-op thread; the encoder-decoder's batches carry frames."""
    cfg = smoke_config(get_config(arch)).replace(**kw)
    api = get_model(cfg)
    params = materialize(api.specs(cfg), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    h = hashlib.sha256()

    def feed(tree):
        for _, x in tree_flatten_with_path(tree):
            h.update(x.detach().float().numpy().tobytes())

    def frames(B):
        if cfg.family != "encdec":
            return {}
        return {"frames": torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32))}
    opt = ST.default_optimizer(cfg)
    step, state = ST.make_train_step(cfg, opt), opt.init(params)
    for i in range(2):
        b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))),
             "labels": torch.from_numpy(rng.integers(-1, cfg.vocab_size, (2, 16))),
             **frames(2)}
        params, state, m = step(params, state, b, i)
        feed(m)
    feed(params)
    feed(state)
    shape = ShapeSuite("serve", 24, 2, "prefill")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    logits, cache = ST.make_prefill_step(cfg, shape, "cpu").fn(
        params, {"tokens": toks, **frames(2)})
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

def launch_argv(arch, root):
    return ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "4",
            "--ckpt-every", "0", "--ckpt-dir", str(root)]


def launcher_one(arch, root, D: int = 1) -> dict:
    """The one-process launcher run of `arch` (at D data blocks' MoE
    semantics)."""
    with moe_blocks(D):
        return TRAIN.main(launch_argv(arch, root))["summary"]


def mesh_run(rank, world, shape, inp, out):
    """Every sharded case of the pickle at `inp` over a (data, model) mesh
    of `shape`; on (2, 1), which is the launcher's own host mesh over 2
    ranks, also the launcher of each family."""
    with open(inp, "rb") as f:
        cases = pickle.load(f)
    out = Path(out)
    mesh = M.make_host_mesh(*shape, device="cpu")
    res = {"modules": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "repro"))}
    res["train"] = {k: train_sharded(c, mesh)
                    for k, c in cases["train"].items()}
    res["serve"] = {k: serve_run(c, mesh) for k, c in cases["serve"].items()}
    res["engine"] = {k: LW.engine_run(c, mesh)
                     for k, c in cases["engine"].items()}
    if shape == (2, 1):
        res["launch"] = {a: TRAIN.main(launch_argv(a, out / a))["summary"]
                         for a in cases["launch"]}
    with open(out / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
