"""The MoE decoders, the RG-LRU LM and the encoder-decoder under a mesh on
CPU gloo groups: `launch.steps`' `make_train_step`, `make_prefill_step`
and `make_decode_step` with `mesh=`, `Engine(mesh=...)` and
`launch.train` under a process group.

Three process groups, spawned once each and run side by side
(`launch.mesh.spawn`, a 150 s join timeout that fails the test): meshes
(1, 2), (2, 1) and (2, 2).  The ranks run
`tests/_torch_families_sharded_worker.py`, which imports neither `jax`
nor `repro` (checked: every rank reports its modules).  They read every
case (the parameters, drawn by the port's `materialize` from
torch.Generator(0), and the batches, as numpy) from a pickle this process
writes; this process runs the one-rank port and the reference (on the
same numpy parameters) alongside.  The smoke configs run in f32 with FSDP
on (`fsdp=True`: on a mesh with 'data' > 1 the parameters are split over
it).

The MoE block keeps the reference's semantics under a mesh
(`models.moe`): at D data blocks its shardmap form dispatches each block
alone at C(T / D) and averages the blocks' aux losses, so the MoE cases
on (2, 1) and (2, 2) are held to the one-rank port running the same two
blocks (`moe_blocks`); on (1, 2) there is one block, and the one-rank port
and the reference are the target as they are.  Pure data parallelism
and the decode fallback keep the global dispatch's semantics, and are
held to the one-rank port at every D.

Tolerance: 1e-5 of each leaf's largest entry for losses, gradient norms,
parameters, logits and caches (the same f32 math summed in another order
over the shards).  The train cases step with sgdm (lr 1e-2), whose update
is linear in the gradient, so the parameters after 3 steps show any
gradient's error at its size; kimi-k2 steps with its own optimizer, lion,
whose sign update moves an element whose gradient sits at round-off by lr
either way, so it is held by loss and gradient norm.  The Engine's tokens
are the one-rank Engine's exactly.  With `mesh=None` the steps are
bitwise the code's before the mesh forms were added: sha256 digests of a
one-thread run of that code are pinned below.
"""
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs import get_config as jget_config, smoke_config as jsmoke
from repro.configs.base import ShapeSuite as JShape
from repro.launch import steps as JSTEPS
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import mesh as M
from repro_torch.models import get_model
from repro_torch.models.module import materialize
from repro_torch.weights import to_numpy

import _torch_families_sharded_worker as W

REL = 1e-5
TIMEOUT = 150
MESHES = [(1, 2), (2, 1), (2, 2)]
S = 16
# name -> (arch, overrides, global batch)
TRAIN = {
    "olmoe": ("olmoe-1b-7b", {"fsdp": True}, 4),
    # a capacity that drops pairs, in one block and in two
    "olmoe-drop": ("olmoe-1b-7b", {"fsdp": True, "capacity_factor": 0.25}, 4),
    # the experts replicated, the batch over the whole mesh
    "olmoe-pure-dp": ("olmoe-1b-7b", {"fsdp": True, "train_pure_dp": True},
                      4),
    "kimi": ("kimi-k2-1t-a32b", {"fsdp": True}, 4),
    "rglru": ("recurrentgemma-9b", {"fsdp": True, "scan_layers": True}, 4),
    # pure DP; under remat a recompute gathers (and sums) again
    "whisper-dp": ("whisper-large-v3", {"fsdp": True, "remat": "full"}, 4),
    "whisper-tp": ("whisper-large-v3", {"fsdp": True}, 3),      # TP
    # heads that do not split whole over 'model' 2
    "rglru-3h": ("recurrentgemma-9b", {"fsdp": True, "n_heads": 3}, 4),
    "whisper-3h": ("whisper-large-v3", {"fsdp": True, "n_heads": 3,
                                        "n_kv_heads": 3}, 3),
}
MOE = ("olmoe", "olmoe-drop", "kimi")          # per-block semantics at D > 1
WITH_REFERENCE = ("olmoe", "rglru", "whisper-dp", "whisper-tp")
# the aux loss alone: one step of the olmoe case
AUX = ("olmoe-1b-7b", {"fsdp": True}, 4)
# name -> (arch, overrides, cache slots)
SERVE = {
    "olmoe": ("olmoe-1b-7b", {"fsdp": True}, 24),
    "kimi": ("kimi-k2-1t-a32b", {"fsdp": True}, 24),
    # 24 slots past the window of 16: the split ring wraps; the remainder
    # layer's state beside the stacked units'
    "rglru": ("recurrentgemma-9b", {"fsdp": True, "scan_layers": True}, 24),
    "whisper": ("whisper-large-v3", {"fsdp": True}, 24),
    "whisper-3h": ("whisper-large-v3", {"n_heads": 3, "n_kv_heads": 3}, 24),
}
SERVE_MOE = ("olmoe", "kimi")               # per-block prefill at D > 1
ENGINE = {"olmoe": ("olmoe-1b-7b", {"fsdp": True}),
          "kimi": ("kimi-k2-1t-a32b", {}),
          "rglru": ("recurrentgemma-9b", {})}
FALLBACK_ROWS = 14
LAUNCH = ("olmoe-1b-7b", "recurrentgemma-9b", "whisper-large-v3")
# sha256 of `W.digest(arch, kw)` on the code before the mesh forms
DIGESTS = {
    ("olmoe-1b-7b", ()):
        "c269c5f9de9c5d01d770ef53204e47b2bc6989c902cdf7e3d48480820dac3332",
    ("kimi-k2-1t-a32b", ()):
        "d1f9d230325abc35d79929ceb396e0329daa38c35b71301d8f4ebf9ee491a00c",
    ("recurrentgemma-9b", ()):
        "8e4f8e9a0710ebd9e089b4c1fd0bbd65f5530dcba446849f0ee2a5ba8a1267e6",
    ("whisper-large-v3", ()):
        "20aae65b08ffe17bf2c0f47f029b1158fd55f473afa5f579cf42bb343fce4437",
    ("olmoe-1b-7b", (("remat", "full"), ("scan_layers", True))):
        "e17b42012a0fd3dbe4c669db3380475d40bb6a2403915792ac5530985bfc76da",
    ("recurrentgemma-9b", (("scan_layers", True),)):
        "8e4f8e9a0710ebd9e089b4c1fd0bbd65f5530dcba446849f0ee2a5ba8a1267e6",
    ("whisper-large-v3", (("remat", "dots"), ("scan_layers", True))):
        "d75969a16e5bce4fd2273b5c1dde2b7ee015917895440c4d3b12fc4e3b11935e",
}


def _cfg(arch, kw):
    return smoke_config(get_config(arch)).replace(**kw)


def _jcfg(arch, kw):
    return jsmoke(jget_config(arch)).replace(**kw)


def _params(arch, kw):
    cfg = _cfg(arch, kw)
    return to_numpy(materialize(get_model(cfg).specs(cfg),
                                torch.Generator().manual_seed(0)))


def _frames(rng, cfg, B):
    if cfg.family != "encdec":
        return {}
    return {"frames": rng.standard_normal(
        (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)}


def _train_case(rng, arch, kw, B, steps=3, **extra):
    cfg = _cfg(arch, kw)
    V = cfg.vocab_size
    return {"arch": arch, "kw": kw, "params": _params(arch, kw),
            "opt": "lion" if arch == "kimi-k2-1t-a32b" else "sgdm",
            "batches": [{"tokens": rng.integers(0, V, (B, S)),
                         "labels": rng.integers(-1, V, (B, S)),
                         **_frames(rng, cfg, B)} for _ in range(steps)],
            **extra}


def _fallback_case(rng):
    """14 single-token rows of olmoe whose layer-0 router sends every row
    to one expert: 14 pairs against the capacity of 8 that C(14) gives."""
    arch, kw = "olmoe-1b-7b", {}
    case = {"arch": arch, "kw": kw, "params": _params(arch, kw), "seq": 4}
    experts = W.route_layer0(case)                        # [V, k]
    counts = np.bincount(experts.reshape(-1))
    e = int(counts.argmax())
    toks = np.flatnonzero((experts == e).any(axis=1))
    toks = np.resize(toks, FALLBACK_ROWS)
    case.update(tokens=toks[:, None], expert=e,
                decode=rng.integers(0, 256, (2, FALLBACK_ROWS, 1)))
    return case


def _cases():
    rng = np.random.default_rng(0)
    cases = {"train": {k: _train_case(rng, *v) for k, v in TRAIN.items()},
             "serve": {}, "engine": {}, "launch": LAUNCH}
    cases["train"]["olmoe-aux"] = _train_case(rng, *AUX, steps=1,
                                              aux_only=True)
    for name, (arch, kw, seq) in SERVE.items():
        cfg = _cfg(arch, kw)
        cases["serve"][name] = {
            "arch": arch, "kw": kw, "params": _params(arch, kw), "seq": seq,
            "tokens": rng.integers(0, cfg.vocab_size, (4, 16)),
            "decode": rng.integers(0, cfg.vocab_size, (8, 4, 1)),
            **_frames(rng, cfg, 4)}
    cases["serve"]["olmoe-fallback"] = _fallback_case(rng)
    for name, (arch, kw) in ENGINE.items():
        cases["engine"][name] = {"arch": arch, "kw": kw,
                                 "params": _params(arch, kw)}
    return cases


def _blocks(name, mesh) -> int:
    """The data blocks whose semantics the case's MoE layers take."""
    return mesh[0] if name in MOE + ("olmoe-aux",) else 1


def _reference_train(case):
    """The reference's jitted train step (one CPU device, its axes Auto, as
    in tests/test_torch_lm_train.py) over the case's batches."""
    jcfg = _jcfg(case["arch"], case["kw"])
    B = case["batches"][0]["tokens"].shape[0]
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    opt = JO.make_optimizer(case["opt"])
    built = JSTEPS.make_train_step(jcfg, mesh, JShape("t", S, B, "train"),
                                   opt)
    jp = jax.tree.map(jnp.asarray, case["params"])
    js = jax.jit(opt.init)(jp)
    out = []
    for s, b in enumerate(case["batches"]):
        jp, js, m = built.jitted(jp, js, jax.tree.map(jnp.asarray, b),
                                 jnp.int32(s))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": out, "params": jax.tree.map(np.asarray, jp)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The three groups and the reference, side by side, and the one-rank
    port's results at each number of data blocks."""
    tmp = tmp_path_factory.mktemp("families_sharded")
    cases = _cases()
    dirs = {s: tmp / f"mesh_{s[0]}x{s[1]}" for s in MESHES}
    for d in dirs.values():
        d.mkdir()
    inp = tmp / "cases.pkl"
    with open(inp, "wb") as f:
        pickle.dump(cases, f)
    errors, ref = {}, {}

    def group(shape):
        try:
            M.spawn(W.mesh_run, shape[0] * shape[1], shape, str(inp),
                    str(dirs[shape]), timeout=TIMEOUT)
        except BaseException as e:          # noqa: BLE001 - reported below
            errors[shape] = e

    def reference():
        for k in WITH_REFERENCE:
            ref[k] = _reference_train(cases["train"][k])
    threads = [threading.Thread(target=group, args=(s,)) for s in MESHES]
    threads.append(threading.Thread(target=reference))
    for t in threads:
        t.start()

    @W.one_thread           # the ranks and the reference share the cores
    def one_rank():
        out = {"train": {}, "serve": {}, "launch": {}}
        for k, c in cases["train"].items():
            for D in sorted({_blocks(k, m) for m in MESHES}):
                out["train"][k, D] = W.train_one(c, D)
        for k, c in cases["serve"].items():
            for D in sorted({m[0] if k in SERVE_MOE else 1 for m in MESHES}):
                out["serve"][k, D] = W.serve_run(c, None, D)
        out["engine"] = {k: W.LW.engine_run(c)
                         for k, c in cases["engine"].items()}
        for a in LAUNCH:
            out["launch"][a] = W.launcher_one(
                a, tmp / "one" / a, 2 if a == "olmoe-1b-7b" else 1)
        return out
    one = one_rank()
    for t in threads:
        t.join()
    assert set(ref) == set(WITH_REFERENCE), "the reference's steps failed"
    assert not errors, errors
    ranks = {}
    for s in MESHES:
        ranks[s] = []
        for r in range(s[0] * s[1]):
            with open(dirs[s] / f"rank{r}.pkl", "rb") as f:
                ranks[s].append(pickle.load(f))
    return {"ranks": ranks, "one": one, "ref": ref, "cases": cases}


def _leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


def _trees_close(got, want, rel=REL, what=""):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, what
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _metrics_close(got, want, what=""):
    assert len(got) == len(want), what
    for s, ((gl, gn), (wl, wn)) in enumerate(zip(got, want)):
        assert abs(gl - wl) <= REL * abs(wl), f"{what} loss, step {s}"
        assert abs(gn - wn) <= REL * abs(wn), f"{what} grad norm, step {s}"


def _routers(tree, path=()):
    """Every MoE router leaf of a parameter tree, by path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_routers(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_routers(v, path + (i,)))
        return out
    return {path: np.asarray(tree, np.float64)} if path[-1] == "router" \
        else {}


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def test_ranks_import_neither_jax_nor_the_reference(run):
    for s in MESHES:
        for r in run["ranks"][s]:
            assert r["modules"] == [], (s, r["modules"])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_step_equals_one_rank_and_the_reference(run, mesh,
                                                              name):
    one = run["one"]["train"][name, _blocks(name, mesh)]
    for rank, r in enumerate(run["ranks"][mesh]):
        got = r["train"][name]
        what = f"{name} {mesh} rank {rank}"
        _metrics_close(got["metrics"], one["metrics"], f"{what} vs one rank")
        if name != "kimi":
            _trees_close(got["params"], one["params"], what=f"{what} params")
        if name in WITH_REFERENCE and mesh == (1, 2):
            ref = run["ref"][name]
            _metrics_close(got["metrics"], ref["metrics"],
                           f"{what} vs the reference")
            _trees_close(got["params"], ref["params"],
                         what=f"{what} params vs the reference")


@pytest.mark.parametrize("mesh", MESHES)
def test_layouts_are_chosen_as_the_reference_chooses_them(run, mesh):
    """whisper's batch of 4 divides the whole mesh: pure DP, as its config
    asks; at 3 it does not: TP.  The MoE test config that asks for pure DP
    takes it; olmoe's own config does not ask."""
    for name, want in (("whisper-dp", True), ("whisper-tp", False),
                       ("olmoe-pure-dp", True), ("olmoe", False),
                       ("rglru", False)):
        for r in run["ranks"][mesh]:
            assert r["train"][name]["pure_dp"] is want, (name, mesh)


def test_moe_blocks_drop_pairs(run):
    """The capacity-0.25 case drops pairs in one block and in two (more
    than the default capacity does), so its sharded steps above, held to
    the one-rank blocks, cover drops."""
    one = run["one"]["train"]
    for D in (1, 2):
        assert one["olmoe-drop", D]["drops"] > one["olmoe", D]["drops"], D


@pytest.mark.parametrize("mesh", MESHES)
def test_the_aux_loss_reaches_the_router_once(run, mesh):
    """With the aux loss alone as the objective (CE weight 0), one sgdm
    step moves every router as the one-rank oracle's gradient does.  Every
    'model' rank computes the same aux from the same tokens; counted once
    a rank and summed over 'model' like the gates' share, it would move
    the routers M times as far."""
    case = run["cases"]["train"]["olmoe-aux"]
    one = run["one"]["train"]["olmoe-aux", _blocks("olmoe-aux", mesh)]
    start = _routers(case["params"])
    want = {k: v - start[k] for k, v in _routers(one["params"]).items()}
    assert want and all(float(np.abs(v).max()) > 0 for v in want.values())
    for rank, r in enumerate(run["ranks"][mesh]):
        got = r["train"]["olmoe-aux"]
        _metrics_close(got["metrics"], one["metrics"], f"{mesh} rank {rank}")
        moved = {k: v - start[k] for k, v in _routers(got["params"]).items()}
        for k, w in want.items():
            err = float(np.abs(moved[k] - w).max())
            scale = float(np.abs(w).max())
            assert err <= REL * scale, (mesh, rank, k, err, scale)


# ---------------------------------------------------------------------------
# The serve steps and the Engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(SERVE))
def test_sharded_prefill_and_decode_equal_one_rank(run, mesh, name):
    """Prefill, then 8 decodes: the logits and the gathered caches.  The
    MoE prompts' 32 tokens a block take the shardmap form at D = 2 (held
    to the one-rank blocks); their decodes, 2 tokens a block, the
    fallback.
    whisper is held to the one-rank port, not the reference, whose serving
    path has faults 10 and 11."""
    one = run["one"]["serve"][name, mesh[0] if name in SERVE_MOE else 1]
    for rank, r in enumerate(run["ranks"][mesh]):
        got = r["serve"][name]
        for i, (g, w) in enumerate(zip(got["logits"], one["logits"])):
            _trees_close(g, w, what=f"{name} {mesh} rank {rank} logits {i}")
        for i, (g, w) in enumerate(zip(got["cache"], one["cache"])):
            _trees_close(g, w, what=f"{name} {mesh} rank {rank} cache {i}")


@pytest.mark.parametrize("mesh", MESHES)
def test_decode_fallback_keeps_the_global_capacity(run, mesh):
    """14 single-token rows, every one routed to one expert by layer 0: 7
    rows a data rank is below one token an expert, so the shardmap config
    falls back to the global dispatch's semantics.  The one-rank dispatch
    keeps 8 of those 14 pairs (C(14) = 8); the ranks together drop as many
    pairs as it does (a rank's are the places past 8 in the whole batch's
    queue: the lower data rank's count is its offset), and their logits are
    its logits.  A per-rank capacity (C(7) = 8 against 7 pairs) would drop
    none of them."""
    one = run["one"]["serve"]["olmoe-fallback", 1]
    assert one["drops"] >= FALLBACK_ROWS - 8
    ranks = run["ranks"][mesh]
    model = mesh[1]
    assert sum(r["serve"]["olmoe-fallback"]["drops"]
               for r in ranks[::model]) == one["drops"]
    for rank, r in enumerate(ranks):
        got = r["serve"]["olmoe-fallback"]
        for i, (g, w) in enumerate(zip(got["logits"], one["logits"])):
            _trees_close(g, w, what=f"fallback {mesh} rank {rank} logits {i}")


@pytest.mark.parametrize("mesh", MESHES)
def test_engine_over_a_mesh_gives_the_one_rank_tokens(run, mesh):
    """Greedy and temperature 0.8, 6 prompts through 4 slots: two slots are
    reused, so an RG-LRU state that was not zeroed would show.  A slot
    admitted again is zero on every rank that holds its row (on 'model'
    2 both ranks hold its h and conv channels)."""
    for name, want in run["one"]["engine"].items():
        assert want["slot_zeroed"] and want["holds_slot"], name
        ranks = [r["engine"][name] for r in run["ranks"][mesh]]
        assert sum(got["holds_slot"] for got in ranks) == mesh[1], \
            (name, mesh)
        for rank, got in enumerate(ranks):
            assert got["tokens"] == want["tokens"], (name, mesh, rank)
            assert got["slot_zeroed"], (name, mesh, rank)


def test_the_dense_moe_oracle_refuses_a_mesh():
    """moe_impl 'dense' (every expert on every token) is the one-device
    oracle: under a mesh the block raises before it reads the mesh."""
    from repro_torch import sharding as SH
    from repro_torch.models import moe as MO
    from repro_torch.models.module import ShardCtx
    cfg = _cfg("olmoe-1b-7b", {"moe_impl": "dense"})
    ctx = ShardCtx({"data": 1, "model": 2},
                   SH.make_rules(cfg, {"data": 1, "model": 2}))
    with pytest.raises(NotImplementedError, match="one-device oracle"):
        MO.moe_block(cfg, {}, torch.zeros(1, 1, cfg.d_model), ctx)


@pytest.mark.parametrize("name", ["rglru-3h", "whisper-3h"])
def test_misaligned_configs_do_not_split_whole_heads(name):
    arch, kw, _ = TRAIN[name]
    cfg = _cfg(arch, kw)
    assert (cfg.n_heads * cfg.head_dim // 2) % cfg.head_dim \
        or (cfg.n_kv_heads * cfg.head_dim // 2) % cfg.head_dim, name


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def test_train_step_collective_counts(run):
    """One smoke step on (1, 2), TP over 'model', one batch block: a MoE
    layer issues 7 all_reduces (forward: the attention's and the experts'
    outputs; backward: the attention's input, the two qk-norm scales, the
    experts' input and the gates); an RG-LRU layer 5 and one all_gather
    (forward: both gates' partial sums, the block's and the MLP's outputs;
    backward: the block's and the MLP's inputs, and the gates' split), the
    local attention layer 4 and 4 all_gathers (its one KV head does not
    split: q, k and v are gathered, and wo's input split in the
    backward); whisper's encoder layer 4, its decoder layer 7 (the cross
    attention adds its output and its two inputs); every step adds the
    vocab-parallel embedding and loss's 5 and one max."""
    r = run["ranks"][(1, 2)][0]["train"]
    L = _cfg("olmoe-1b-7b", {}).n_layers
    assert r["olmoe"]["counts"] == {"all_reduce_sum": 7 * L + 5,
                                    "all_reduce_max": 1}
    assert r["rglru"]["counts"] == {"all_reduce_sum": 5 * 3 + 4 + 5,
                                    "all_gather": 3 + 4, "all_reduce_max": 1}
    w = _cfg("whisper-large-v3", {})
    assert r["whisper-tp"]["counts"] == {
        "all_reduce_sum": 4 * w.enc_layers + 7 * w.n_layers + 5,
        "all_reduce_max": 1}


def test_decode_step_collective_counts(run):
    """One decode step.  On (1, 2): an olmoe layer gathers q, k and v,
    merges the split cache's partial softmaxes (a max and a sum) and sums
    wo's and the experts' outputs; an RG-LRU layer sums the gates, the
    block's and the MLP's outputs, the attention layer as olmoe's but the
    MLP; a whisper decoder layer adds to its self attention's the cross
    attention's q gather, merge and wo sum; each step adds the embedding's
    sum.  On (2, 1), 2 rows a data rank, the olmoe fallback gathers the
    experts' counts and sums the aux loss's probabilities a layer, beside
    the FSDP gathers (the top-level leaves and one a unit)."""
    r = run["ranks"][(1, 2)][0]["serve"]
    L = _cfg("olmoe-1b-7b", {}).n_layers
    assert r["olmoe"]["decode_counts"] == {
        "all_gather": 3 * L, "all_reduce_max": L, "all_reduce_sum": 3 * L + 1}
    assert r["rglru"]["decode_counts"] == {
        "all_gather": 3, "all_reduce_max": 1, "all_reduce_sum": 3 * 3 + 3 + 1}
    L = _cfg("whisper-large-v3", {}).n_layers
    assert r["whisper"]["decode_counts"] == {
        "all_gather": 4 * L, "all_reduce_max": 2 * L,
        "all_reduce_sum": 5 * L + 1}
    L = _cfg("olmoe-1b-7b", {}).n_layers
    assert run["ranks"][(2, 1)][0]["serve"]["olmoe"]["decode_counts"] == {
        "all_gather": 1 + L + L, "all_reduce_sum": L}


# ---------------------------------------------------------------------------
# The launcher, mesh=None
# ---------------------------------------------------------------------------

def test_launcher_over_a_process_group(run):
    """`launch.train --smoke` on 2 ranks (the host mesh (2, 1)) for olmoe,
    recurrentgemma and whisper reports the final loss of the one-process
    run; olmoe's at two data blocks' MoE semantics, whisper in pure DP."""
    for r in run["ranks"][(2, 1)]:
        for arch in LAUNCH:
            s, one = r["launch"][arch], run["one"]["launch"][arch]
            assert s["mesh"] == {"data": 2, "model": 1}, arch
            assert s["pure_dp"] is (arch == "whisper-large-v3"), arch
            assert s["final_step"] == one["final_step"] == 4, arch
            assert abs(s["final_loss"] - one["final_loss"]) <= \
                REL * abs(one["final_loss"]), arch


@pytest.mark.parametrize("arch,kw", [(a, dict(k)) for a, k in DIGESTS])
def test_one_device_steps_are_bitwise_unchanged(arch, kw):
    assert W.digest(arch, kw) == DIGESTS[(arch, tuple(sorted(kw.items())))]
