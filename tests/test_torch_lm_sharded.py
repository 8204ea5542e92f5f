"""The LM's sharded steps on CPU gloo groups: `launch.steps`'
`make_train_step`, `make_prefill_step` and `make_decode_step` with
`mesh=`, `Engine(mesh=...)` and `launch.train` under a process group, for
RWKV6 and the dense decoders.

Three process groups, spawned once each and run side by side
(`launch.mesh.spawn`, a 150 s join timeout that fails the test): meshes
(1, 2), (2, 1) and (2, 2).  The ranks run `tests/_torch_lm_sharded_worker.py`,
which imports neither `jax` nor `repro` (checked: every rank reports its
modules).  They read every case (the parameters, drawn by the port's
`materialize` from torch.Generator(0), and the batches, as numpy) from a
pickle this process writes; this process runs the one-rank port and the
reference (on the same numpy parameters) alongside, and holds the ranks'
results against them.  The smoke configs run in f32 with FSDP on
(`fsdp=True`: on a mesh with 'data' > 1 the parameters are split over it).

Tolerances: 1e-5 of each leaf's largest entry for losses, gradient norms,
parameters, logits and caches (the same f32 math summed in another order
over the shards).  RWKV6's parameters get 2e-4, the bar
`tests/test_torch_lm_train.py` holds its gradients to against the
reference: the per-head group norm (eps 6.4e-4) divides by the tiny
spread of a head's WKV output at some positions, so a zero-initialised
LoRA leaf, which after 3 steps is a sum of gradients of both signs, moves
by ~1e-5 of its size when the batch is summed in another order, as the
one-rank port and the reference differ there.  The CPU's 1- and 8-thread
runs agree bitwise at this size, so their spread gives no bar.  The train cases step with sgdm (lr 1e-2), whose update is
linear in the gradient, so the parameters after 3 steps show any
gradient's error at its size.  adamw, the configs' own, moves an element
whose gradient sits at round-off by up to lr a step either way (its
first step is lr * g / |g|), so its case is held by loss and gradient
norm, which read the updated parameters at steps 2 and 3.  The Engine's
tokens are the one-rank Engine's exactly.  With `mesh=None` the
steps are bitwise the code's before the mesh forms were added: sha256
digests of a one-thread run of that code are pinned below.
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
from repro_torch.configs.base import ShapeSuite
from repro_torch.launch import mesh as M, steps as STEPS
from repro_torch.models import get_model
from repro_torch.models.module import materialize
from repro_torch.weights import to_numpy

import _torch_lm_sharded_worker as W

REL = 1e-5
RWKV_REL = 2e-4
TIMEOUT = 150
MESHES = [(1, 2), (2, 1), (2, 2)]
# name -> (arch, overrides, global batch)
TRAIN = {
    "rwkv6-3b": ("rwkv6-3b", {"fsdp": True}, 4),                # pure DP
    "gemma2-2b": ("gemma2-2b", {"fsdp": True, "scan_layers": True}, 4),
    "qwen3-8b": ("qwen3-8b", {"fsdp": True}, 4),                # TP
    # does not divide: TP; under remat a recompute gathers and sums again
    "gemma2-2b-b3": ("gemma2-2b", {"fsdp": True, "remat": "full"}, 3),
    # heads that do not split whole over 'model' 2
    "rwkv6-3h": ("rwkv6-3b", {"fsdp": True, "d_model": 48,
                              "train_pure_dp": False}, 4),
    "qwen3-gqa": ("qwen3-8b", {"fsdp": True, "n_heads": 6,
                               "n_kv_heads": 3}, 4),
    "qwen3-8b-adamw": ("qwen3-8b", {"fsdp": True}, 4),
    # adafactor's factored moments: TP, and pure DP with FSDP over 'data'
    "qwen3-8b-adafactor": ("qwen3-8b", {"fsdp": True}, 4),
    "gemma2-2b-adafactor": ("gemma2-2b", {"fsdp": True}, 4),
    # the VLM: its patch embeddings through the projector
    "internvl2-2b": ("internvl2-2b", {"fsdp": True}, 4),
}
ADAMW = ("qwen3-8b-adamw",)
ADAFACTOR = ("qwen3-8b-adafactor", "gemma2-2b-adafactor")
WITH_REFERENCE = ("rwkv6-3b", "gemma2-2b", "qwen3-8b")
# name -> (arch, overrides, cache slots)
SERVE = {
    "rwkv6-3b": ("rwkv6-3b", {"fsdp": True}, 24),
    "gemma2-2b": ("gemma2-2b", {"fsdp": True}, 24),     # ring and linear
    "qwen3-8b": ("qwen3-8b", {"fsdp": True, "scan_layers": True}, 24),
    "qwen3-8b-s25": ("qwen3-8b", {}, 25),      # the cache splits by kv heads
    "rwkv6-3h": ("rwkv6-3b", {"d_model": 48}, 24),
    "qwen3-gqa": ("qwen3-8b", {"n_heads": 6, "n_kv_heads": 3}, 24),
    "minitron-8b": ("minitron-8b", {"fsdp": True}, 24),        # relu^2 MLP
}
ENGINE = {"rwkv6-3b": ("rwkv6-3b", {"fsdp": True}),
          "gemma2-2b": ("gemma2-2b", {})}
# sha256 of `W.digest(arch, kw)` on the code before the mesh forms
DIGESTS = {
    ("rwkv6-3b", ()):
        "c802cba289c0f98db11439805b2da0d3800e810d8d125970d30ff9d301ce90e2",
    ("gemma2-2b", (("remat", "full"), ("scan_layers", True))):
        "c86e2075e3d0cd97998a6c3c69eebeba3b33ef9c1e0ea966573823fa77fe0455",
    ("qwen3-8b", ()):
        "477ea9b09167a7b09d688af0ea177efee5d837d4871a8d4c42113fcfedb8c672",
    ("yi-6b", (("n_microbatches", 2),)):
        "159ec0ffc677f95d5aa0126d01afcae7c058a0ba2da89c4ca26f9a4f47cc51e8",
}


def _jcfg(arch, kw):
    return jsmoke(jget_config(arch)).replace(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(arch, kw):
    cfg = smoke_config(get_config(arch)).replace(**kw)
    return to_numpy(materialize(get_model(cfg).specs(cfg),
                                torch.Generator().manual_seed(0)))


def _cases():
    rng = np.random.default_rng(0)
    cases = {"train": {}, "serve": {}, "engine": {}}
    for name, (arch, kw, B) in TRAIN.items():
        V = _jcfg(arch, kw).vocab_size
        P = _jcfg(arch, kw).n_patches
        patches = (lambda: {"patch_embeds": rng.standard_normal(
            (B, P, 4096)).astype(np.float32)}) if P else dict
        cases["train"][name] = {
            "arch": arch, "kw": kw, "params": _params(arch, kw),
            "opt": ("adamw" if name in ADAMW else "adafactor"
                    if name in ADAFACTOR else "sgdm"),
            "batches": [{"tokens": rng.integers(0, V, (B, 16)),
                         "labels": rng.integers(-1, V, (B, 16)),
                         **patches()} for _ in range(3)]}
    for name, (arch, kw, seq) in SERVE.items():
        V = _jcfg(arch, kw).vocab_size
        cases["serve"][name] = {
            "arch": arch, "kw": kw, "params": _params(arch, kw), "seq": seq,
            "tokens": rng.integers(0, V, (4, 16)),
            "decode": rng.integers(0, V, (W.N_DECODE, 4, 1))}
    for name, (arch, kw) in ENGINE.items():
        cases["engine"][name] = {"arch": arch, "kw": kw,
                                 "params": _params(arch, kw)}
    return cases


def _reference_train(case):
    """The reference's jitted train step (one CPU device, its axes Auto, as
    in tests/test_torch_lm_train.py) over the case's 3 batches."""
    jcfg = _jcfg(case["arch"], case["kw"])
    B = case["batches"][0]["tokens"].shape[0]
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    opt = JO.make_optimizer(case["opt"])
    built = JSTEPS.make_train_step(jcfg, mesh, JShape("t", 16, B, "train"),
                                   opt)
    jp = jax.tree.map(jnp.asarray, case["params"])
    js = jax.jit(opt.init)(jp)
    out = []
    for s, b in enumerate(case["batches"]):
        jp, js, m = built.jitted(jp, js, jax.tree.map(jnp.asarray, b),
                                 jnp.int32(s))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": out, "params": _np(jp)}


def _reference_pure_dp(arch, kw, B, shape):
    """The reference's own pure-DP choice, read off the rules it builds
    over an abstract mesh of `shape`."""
    seen = []
    orig = JSTEPS.make_rules

    def rec(cfg, mesh, **k):
        seen.append(k.get("pure_dp", False))
        return orig(cfg, mesh, **k)
    JSTEPS.make_rules = rec
    try:
        JSTEPS.make_train_step(_jcfg(arch, kw),
                               jax.sharding.AbstractMesh(shape, ("data", "model")),
                               JShape("t", 16, B, "train"))
    finally:
        JSTEPS.make_rules = orig
    return seen[-1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The three groups, side by side (the (2, 1) group waits for the
    checkpoints the (1, 2) group writes), and the one-rank port's and the
    reference's results."""
    tmp = tmp_path_factory.mktemp("lm_sharded")
    cases = _cases()
    dirs = {s: tmp / f"mesh_{s[0]}x{s[1]}" for s in MESHES}
    for d in dirs.values():
        d.mkdir()
    cases["ckpt_from"] = str(dirs[(1, 2)])
    inp = tmp / "cases.pkl"
    with open(inp, "wb") as f:
        pickle.dump(cases, f)
    errors = {}

    def group(shape):
        try:
            M.spawn(W.mesh_run, shape[0] * shape[1], shape, str(inp),
                    str(dirs[shape]), timeout=TIMEOUT)
        except BaseException as e:          # noqa: BLE001 - reported below
            errors[shape] = e
    ref = {}

    def reference():
        for k in WITH_REFERENCE:
            ref[k] = _reference_train(cases["train"][k])
    threads = [threading.Thread(target=group, args=(s,)) for s in MESHES]
    threads.append(threading.Thread(target=reference))
    for t in threads:
        t.start()

    @W.one_thread           # the ranks and the reference share the cores
    def one_rank():
        return {"train": {k: W.train_one(c)
                          for k, c in cases["train"].items()},
                "serve": {k: W.serve_run(c)
                          for k, c in cases["serve"].items()},
                "engine": {k: W.engine_run(c)
                           for k, c in cases["engine"].items()}}
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
    for s, ((gl, gn), (wl, wn)) in enumerate(zip(got, want)):
        assert abs(gl - wl) <= REL * abs(wl), f"{what} loss, step {s}"
        assert abs(gn - wn) <= REL * abs(wn), f"{what} grad norm, step {s}"


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
    one = run["one"]["train"][name]
    for rank, r in enumerate(run["ranks"][mesh]):
        got = r["train"][name]
        _metrics_close(got["metrics"], one["metrics"],
                       f"{name} {mesh} rank {rank} vs one rank")
        prel = RWKV_REL if TRAIN[name][0] == "rwkv6-3b" else REL
        if name not in ADAMW:
            _trees_close(got["params"], one["params"], prel,
                         f"{name} {mesh} params")
        if name in WITH_REFERENCE:
            ref = run["ref"][name]
            _metrics_close(got["metrics"], ref["metrics"],
                           f"{name} {mesh} vs the reference")
            _trees_close(got["params"], ref["params"], prel,
                         f"{name} {mesh} params vs the reference")


@pytest.mark.parametrize("mesh", MESHES)
def test_pure_dp_is_chosen_as_the_reference_chooses_it(run, mesh):
    """Both ways: the batches that divide over the whole mesh take pure DP
    (rwkv6, gemma2 at 4), the one that does not (gemma2 at 3), and the
    archs that do not ask for it, take TP."""
    seen = set()
    for name, (arch, kw, B) in TRAIN.items():
        got = run["ranks"][mesh][0]["train"][name]["pure_dp"]
        assert got == _reference_pure_dp(arch, kw, B, mesh), (name, mesh)
        assert got == STEPS.pure_dp_for(smoke_config(get_config(arch))
                                        .replace(**kw), dict(zip(
                                            ("data", "model"), mesh)),
                                        ShapeSuite("t", 16, B, "train"))
        seen.add(got)
    assert seen == {True, False}


def test_each_rank_holds_only_its_shard(run):
    """qwen3 on (1, 2) splits the attention, MLP and vocab over 'model'; on
    (2, 2) FSDP splits the rest over 'data' too."""
    full = sum(x.size for x in jax.tree.leaves(
        run["cases"]["train"]["qwen3-8b"]["params"]))
    n12 = run["ranks"][(1, 2)][0]["train"]["qwen3-8b"]["local_numel"]
    n22 = run["ranks"][(2, 2)][0]["train"]["qwen3-8b"]["local_numel"]
    assert n12 < 0.6 * full and n22 < 0.3 * full, (n12, n22, full)


def test_train_step_collective_counts(run):
    """One smoke step's collectives.  qwen3 on (1, 2), TP over 'model', one
    batch shard: a layer issues 6 all_reduces (forward: the attention's and
    the MLP's row-parallel outputs; backward: the two column-parallel
    inputs and the two qk-norm scales, which act on the rank's heads);
    the step adds 5 (the vocab-parallel embedding, the logits' input in
    the backward, the sum of exponentials, the gold logit, the norm) and
    one max (the logsumexp's).  gemma2 on (2, 2), pure DP with FSDP over
    'data': one all_gather of the top-level leaves and one a unit, each
    with one all_reduce in the backward; the loss's two sums and count;
    one bucket of gradients over 'model'; the norm."""
    L = smoke_config(get_config("qwen3-8b")).n_layers
    assert run["ranks"][(1, 2)][0]["train"]["qwen3-8b"]["counts"] == {
        "all_reduce_sum": 6 * L + 5, "all_reduce_max": 1}
    units = smoke_config(get_config("gemma2-2b")).n_layers // 2
    assert run["ranks"][(2, 2)][0]["train"]["gemma2-2b"]["counts"] == {
        "all_gather": 1 + units, "all_reduce_sum": (1 + units) + 3 + 1 + 1}


# ---------------------------------------------------------------------------
# The serve steps and the Engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(SERVE))
def test_sharded_prefill_and_decode_equal_one_rank(run, mesh, name):
    one = run["one"]["serve"][name]
    for rank, r in enumerate(run["ranks"][mesh]):
        got = r["serve"][name]
        for i, (g, w) in enumerate(zip(got["logits"], one["logits"])):
            _trees_close(g, w, what=f"{name} {mesh} rank {rank} logits {i}")
        for i, (g, w) in enumerate(zip(got["cache"], one["cache"])):
            _trees_close(g, w, what=f"{name} {mesh} rank {rank} cache {i}")


def test_decode_step_collective_counts(run):
    """One decode step on (1, 2).  qwen3: a layer gathers q, k and v over
    'model' (the cache splits along the sequence: every rank attends over
    its slots for all heads), merges the partial softmaxes (one max, one
    sum of the exp-sums and P.V) and sums the wo and MLP outputs; the step
    adds the embedding's sum.  RWKV6: a layer gathers x_tm, x_cm and rr and
    sums the Wo and Wv outputs; the step adds the embedding's sum."""
    L = smoke_config(get_config("qwen3-8b")).n_layers
    r = run["ranks"][(1, 2)][0]["serve"]
    assert r["qwen3-8b"]["decode_counts"] == {
        "all_gather": 3 * L, "all_reduce_max": L, "all_reduce_sum": 3 * L + 1}
    L = smoke_config(get_config("rwkv6-3b")).n_layers
    assert r["rwkv6-3b"]["decode_counts"] == {
        "all_gather": 3 * L, "all_reduce_sum": 2 * L + 1}


@pytest.mark.parametrize("mesh", MESHES)
def test_engine_over_a_mesh_gives_the_one_rank_tokens(run, mesh):
    """Greedy and temperature 0.8, 6 prompts through 4 slots: two slots are
    reused, so a recurrent state that was not zeroed would show."""
    for name, want in run["one"]["engine"].items():
        assert want["slot_zeroed"] and want["holds_slot"], name
        ranks = [r["engine"][name] for r in run["ranks"][mesh]]
        assert any(got["holds_slot"] for got in ranks), (name, mesh)
        for rank, got in enumerate(ranks):
            assert got["tokens"] == want["tokens"], (name, mesh, rank)
            assert got["slot_zeroed"], (name, mesh, rank)


# ---------------------------------------------------------------------------
# The launcher, the refusals, mesh=None
# ---------------------------------------------------------------------------

def _one_process_summary(tmp_path, arch):
    from repro_torch.launch import train as TRAIN
    return TRAIN.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "6", "--ckpt-every", "2", "--ckpt-dir",
                       str(tmp_path / arch)])["summary"]


def test_launcher_over_a_process_group(run, tmp_path):
    """gemma2-2b --smoke on 2 ranks (the host mesh (2, 1), pure DP) reports
    the one-process run's loss; qwen3-8b crashed at step 3 over (1, 2)
    resumes on (2, 1) from its sharded checkpoint and ends at the
    one-process run's loss; --production-mesh on 2 ranks raises."""
    r12, r21 = run["ranks"][(1, 2)], run["ranks"][(2, 1)]
    for r in r12:
        assert r["crash"] == {"restarts": 1, "final_step": 4}
    one = _one_process_summary(tmp_path, "gemma2-2b")
    for r in r21:
        s = r["launch"]
        assert s["mesh"] == {"data": 2, "model": 1} and s["pure_dp"]
        assert s["final_step"] == 6
        assert abs(s["final_loss"] - one["final_loss"]) <= \
            REL * abs(one["final_loss"])
        assert "256 ranks" in r["production"]
    one = _one_process_summary(tmp_path, "qwen3-8b")
    for r in r21:
        s = r["resume"]
        assert s["final_step"] == 6 and s["restarts"] == 0
        assert abs(s["final_loss"] - one["final_loss"]) <= \
            REL * abs(one["final_loss"])


def test_families_not_ported_under_a_mesh_refuse(run):
    """Nothing refuses under a mesh any more: the MoE decoders, rglru and
    encdec build their train step, prefill step and Engine over the mesh,
    adafactor its train step, and the launcher builds the MoE arch's run
    over it without writing anything."""
    for r in run["ranks"][(1, 2)]:
        refusals = dict(r["refusals"])
        assert not refusals.pop("launcher_wrote")
        assert set(refusals) == {"moe", "rglru", "encdec", "adafactor",
                                 "launcher"}
        for name, msgs in refusals.items():
            assert msgs and all(m is None for m in msgs), (name, msgs)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ADAFACTOR)
def test_adafactor_moments_are_the_one_rank_moments_slices(run, mesh, name):
    """adafactor over the mesh: each rank's factored moments gathered by
    their placements equal the one-rank moments within 1e-5 (so each
    shard is the slice of them); where the leaves are split (TP over
    'model', FSDP over 'data'), so are the moments."""
    one = run["one"]["train"][name]["opt"]
    for r in run["ranks"][mesh]:
        got = r["train"][name]
        _trees_close(got["opt"], one, what=f"{name} {mesh} moments")
        local, whole = map(sum, zip(*got["opt_numel"]))
        split = not got["pure_dp"] or mesh[0] > 1
        assert (local < whole) == split, (name, mesh, local, whole)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_a_ranks_meta_count_is_its_count_on_real_tensors(run, kind):
    """The dry-run's per-rank count (`dryrun_lib.count_rank`) on the (1, 2)
    mesh: qwen3-8b's smoke train and prefill steps on each rank's local
    meta shards count the FLOPs and the collective result bytes, by kind,
    that the same rank counts on its real placed tensors in the gloo
    group."""
    for r in run["ranks"][(1, 2)]:
        (f_meta, c_meta), (f_real, c_real) = r["meta_vs_real"][kind]
        assert f_meta == f_real > 0
        assert c_meta == c_real and sum(c_real.values()) > 0


@pytest.mark.parametrize("arch,kw", [(a, dict(k)) for a, k in DIGESTS])
def test_one_device_steps_are_bitwise_unchanged(arch, kw):
    assert W.digest(arch, kw) == DIGESTS[(arch, tuple(sorted(kw.items())))]


def test_launcher_under_torchrun_joins_its_group(tmp_path):
    """`torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train`
    trains over the host mesh (2, 1): the launcher joins torchrun's gloo
    group itself, and rank 0 prints the summary."""
    import json
    import os
    import subprocess
    import sys
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "gemma2-2b", "--smoke", "--device", "cpu", "--steps", "2",
         "--ckpt-every", "0", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=TIMEOUT, env=env, check=True)
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == 1, out.stdout[-2000:]
    assert lines[0]["mesh"] == {"data": 2, "model": 1}
    assert lines[0]["final_step"] == 2
