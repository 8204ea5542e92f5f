"""The port's sharded carry on a CPU gloo group: the scaled engine's
column-sharded step (`core.learner.ScaledLearner.place`), its rewire
migration, sharded checkpoints and re-mesh restore, the trainers' re-mesh
resume, `runtime.compression`, `data.pipeline.ShardedHostLoader` and
`models.moe.moe_block_shardmap`.

Three process groups, spawned once each (`launch.mesh.spawn`, a 120 s
join timeout that fails the test): mesh (1, 2), mesh (2, 2) and mesh
(2, 1), the last restoring what the first wrote.  The ranks run
`tests/_torch_sharded_worker.py`, which imports neither `jax` nor `repro`
(checked: every rank reports its modules); they read the reference's
parameters, masks and streams from a pickle this process writes, and this
process holds their results against the reference.

Tolerances: the sharded carry's influence state is bitwise the one-rank
port's (the same products on a column slice); its loss and gradients
within 1e-5 of each tree's largest magnitude of the one-rank port's and of
the reference's `compact_step` / `rtrl_grads` (f32; the batch mean is
summed in another order over the batch shards); the migrated carry, the
checkpoints and the MoE block run to run bitwise; the MoE block within
2 x 2^-7 of the largest output of `dispatch` (one bf16 step a rounding,
two roundings: the shards' partial sums and their sum; as on the card).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import ckpt as JCK
from repro.core import cells as JC, scaled_rtrl as JSR
from repro.sparsity import migrate as JMIG, schedule as JSCH
from repro_torch.checkpoint import load_checkpoint
from repro_torch.launch import mesh as M

REL = 1e-5
MOE_REL = 2 * 2.0 ** -7
TIMEOUT = 120
T = 6


def _case(L, seed=0):
    """The reference's parameters, masks and a stream at n = 32, as
    numpy, with its compact_step state after T steps and its rtrl_grads."""
    cfgd = dict(n=32, n_in=8, batch=4, n_layers=L, beta_capacity=1.0,
                sparsity=0.5)
    jcfg = JSR.ScaledRTRLConfig(**cfgd)
    jp, jm = JSR.init_params(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed + 1)
    xs = rng.standard_normal((T, 4, 8)).astype(np.float32)
    labels = (np.arange(4) % jcfg.n_out).astype(np.int32)
    jcl = jcfg.col_layout(jm)
    w = jp["layers"] if L > 1 else JC.rec_param_tree(jp)
    step = jax.jit(lambda s, x: JSR.compact_step(jcfg, w, s, x, cl=jcl)[0])
    st = JSR.init_state(jcfg, jcl)
    for t in range(T):
        st = step(st, jnp.asarray(xs[t]))
    loss, grads, _ = JSR.rtrl_grads(jcfg, jp, jnp.asarray(xs),
                                    jnp.asarray(labels), jm)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    case = {"cfg": cfgd, "params": np_tree(jp), "masks": np_tree(jm),
            "xs": xs, "labels": labels}
    ref = {"state": np_tree(st), "loss": float(loss), "grads": np_tree(grads)}
    if L == 1:
        new = JSCH.rewire_masks(jm, JC.rec_param_tree(jp), None, frac=0.3,
                                key=jax.random.key(5), method="set")
        vals = rng.standard_normal((4, jcfg.K, jcl.Pc_pad)).astype(np.float32)
        case["new_masks"], case["vals"] = np_tree(new), vals
        ref["migrated"] = np.asarray(JMIG.migrate_influence(
            jcl, jcfg.col_layout(new), jnp.asarray(vals)))
    return case, ref


@pytest.fixture(scope="module")
def ref():
    return {L: _case(L) for L in (1, 2)}


def _spawn(fn_name, world, tmp, inputs):
    import _torch_sharded_worker as W
    inp = tmp / "inputs.pkl"
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    M.spawn(getattr(W, fn_name), world, str(inp), str(tmp), timeout=TIMEOUT)
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def g12(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_1x2")
    return tmp, _spawn("mesh_1x2", 2, tmp,
                       {"scaled": {L: c for L, (c, _) in ref.items()}})


@pytest.fixture(scope="module")
def g22(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_2x2")
    return _spawn("mesh_2x2", 4, tmp,
                  {"scaled": {L: c for L, (c, _) in ref.items()}})


@pytest.fixture(scope="module")
def g21(ref, g12, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_2x1")
    return _spawn("mesh_2x1", 2, tmp,
                  {"scaled": {L: c for L, (c, _) in ref.items()},
                   "ckpt_dir": str(g12[0] / "ckpt")})


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _trees_close(got, want, rel=REL, what=""):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), what
    scale = max(max(float(np.abs(w).max()) for w in want), 1e-3)
    for g, w in zip(got, want):
        assert g.shape == w.shape, what
        err = float(np.abs(np.float64(g) - np.float64(w)).max())
        assert err <= rel * scale, f"{what}: {err:.3e} of {scale:.3e}"


def _trees_equal(a, b, what=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=what)


def _groups(g12, g22):
    return {(1, 2): g12[1], (2, 2): g22}


# ---------------------------------------------------------------------------
# The scaled engine's sharded step
# ---------------------------------------------------------------------------

CASES = [(L, b) for L in (1, 2) for b in ("compact", "compact_fused")]


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
@pytest.mark.parametrize("L,backend", CASES)
def test_sharded_scaled_step_equals_one_rank_and_the_reference(
        g12, g22, ref, mesh, L, backend):
    """The gathered carry is bitwise the one-rank port's; the loss and
    gradients equal the one-rank port's and the reference's rtrl_grads,
    the state the reference's compact_step, within 1e-5; every rank
    agrees; no rank imported jax."""
    ranks = _groups(g12, g22)[mesh]
    want = ref[L][1]
    for r in ranks:
        assert r["jax_imported"] == []
        res = r["scaled"][(L, backend, None)]
        _trees_equal(res["sharded"]["state"], res["one"]["state"], "state")
        _trees_close(res["sharded"]["grads"], res["one"]["grads"],
                     what="grads vs one rank")
        _trees_close(res["sharded"]["grads"], want["grads"],
                     what="grads vs reference")
        _trees_close(res["sharded"]["state"], want["state"],
                     what="state vs reference compact_step")
        assert abs(res["sharded"]["loss"] - want["loss"]) <= REL * max(
            abs(want["loss"]), 1e-3)
        _trees_equal(res["sharded"], ranks[0]["scaled"][(L, backend, None)]
                     ["sharded"], "ranks differ")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
@pytest.mark.parametrize("L,backend", CASES)
def test_sharded_update_issues_no_collective(g12, g22, mesh, L, backend):
    """CommDebugMode counts 0 collectives over the T steps; grads issues
    one all_gather over 'model' and, with 2 batch shards, one all_reduce
    over 'data'; each rank holds its half of the columns and its batch
    rows, and the plain K1 ran once a layer a step on that half."""
    for r in _groups(g12, g22)[mesh]:
        res = r["scaled"][(L, backend, None)]
        assert res["steps_comm"] == 0
        want = {"all_gather": 1}
        if mesh[0] > 1:
            want["all_reduce_sum"] = 1
        assert res["grad_colls"] == want
        assert res["update_comm"] == len(want)
        full_w = res["one"]["state"]["vals"]
        full_w = (full_w[0] if L > 1 else full_w).shape
        assert res["local_vals"] == (full_w[0] // mesh[0], full_w[1],
                                     full_w[2] // 2)
        if backend == "compact_fused":
            assert res["k1_widths"] == [full_w[2] // 2] * (T * L)
        else:
            assert res["k1_widths"] == []


def test_full_width_carry_shards_too(g12):
    """col_compact=False: the full P_pad-wide carry split over 'model' (its
    dead columns tracked too), against the one-rank port's full-width run
    (which tests/test_torch_scaled.py holds to the reference)."""
    for r in g12[1]:
        res = r["scaled"][(1, "compact", False)]
        _trees_equal(res["sharded"]["state"], res["one"]["state"])
        _trees_close(res["sharded"]["grads"], res["one"]["grads"])
        assert res["steps_comm"] == 0


# ---------------------------------------------------------------------------
# Rewire migration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_sharded_migration_is_the_unsharded_one(g12, g22, ref, mesh):
    """migrate_sharded's columns are array_equal to the port's unsharded
    migrate_influence and to the reference's, on the same masks; one
    all_gather over 'model'."""
    want = ref[1][1]["migrated"]
    for r in _groups(g12, g22)[mesh]:
        mig = r["migration"]
        np.testing.assert_array_equal(mig["migrated_local"],
                                      mig["migrated_whole"])
        w = mig["migrated_local"].shape[-1]
        i = [x["migration"]["migrated_local"] is mig["migrated_local"]
             for x in _groups(g12, g22)[mesh]].index(True)
        c0 = (i % 2) * w
        np.testing.assert_array_equal(mig["migrated_local"],
                                      want[..., c0:c0 + w])


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_sharded_rigl_event_equals_one_rank(g12, g22, mesh):
    """A RigL event on the sharded carry: on one batch shard the migrated
    carry is bitwise the one-rank event's and the next steps' gradients
    equal it; one all_gather over 'model', and with 2 batch shards one
    all_reduce of the scores."""
    for r in _groups(g12, g22)[mesh]:
        mig = r["migration"]
        want = {"all_gather": 1}
        if mesh[0] > 1:
            want["all_reduce_sum"] = 1
        assert mig["event_colls"] == want
        if mesh[0] == 1:
            np.testing.assert_array_equal(mig["vals_sharded"],
                                          mig["vals_one"])
            np.testing.assert_array_equal(mig["gw_sharded"], mig["gw_one"])
        _trees_close(mig["grads_sharded"], mig["grads_one"])


# ---------------------------------------------------------------------------
# Checkpoints and re-mesh
# ---------------------------------------------------------------------------

def _ckpt_like(g12):
    return {"carry": {k: v for k, v in g12[1][0]["ckpt_gathered"].items()}}


def test_sharded_checkpoint_restores_on_one_rank_and_in_the_reference(g12):
    """The (1, 2) ranks' sharded checkpoint: the port restores it on one
    rank and the reference's load_checkpoint reads it, both bitwise the
    gathered carry; the vals leaf is written as 2 shards with the
    reference's index entries."""
    import json
    root = g12[0] / "ckpt"
    want = g12[1][0]["ckpt_gathered"]
    man = json.loads((root / "step_00000001" / "manifest.json").read_text())
    by = {e["name"]: e for e in man["leaves"]}
    vals = by["carry__state__vals"]
    w = vals["shape"][2] // 2
    assert [s["index"] for s in vals["shards"]] == [
        [[None, None], [None, None], [0, w]],
        [[None, None], [None, None], [w, 2 * w]]]
    assert len(by["carry__params__out__W"]["shards"]) == 1
    import torch
    like = {"carry": jax.tree.map(lambda a: torch.zeros(a.shape,
                                                         dtype=torch.float32
                                                         if a.dtype.kind == "f"
                                                         else torch.int32),
                                  want)}
    got, step = load_checkpoint(root, like)
    assert step == 1
    _trees_equal(jax.tree.map(lambda t: t.numpy(), got["carry"]), want)
    jlike = {"carry": jax.tree.map(jnp.asarray, want)}
    jgot, jstep = JCK.load_checkpoint(root, jlike)
    assert jstep == 1
    _trees_equal(jgot["carry"], want)


def test_checkpoint_written_on_1x2_continues_on_2x1(g21):
    """Restored onto mesh (2, 1) by the learner's target shardings (batch
    over 'data' now), 4 more steps equal the one-rank continuation of the
    same checkpoint: bitwise state, gradients within 1e-5."""
    for r in g21:
        assert r["jax_imported"] == []
        assert r["placements"]["vals"] == "(Shard(dim=0), Shard(dim=2))"
        _trees_equal(r["continued_sharded"]["state"],
                     r["continued_one"]["state"])
        _trees_close(r["continued_sharded"]["grads"],
                     r["continued_one"]["grads"])


def test_online_trainer_resumes_onto_a_different_mesh(g21):
    """test_guard.py:373: a run checkpointed without a mesh resumes on mesh
    (2, 1) with every leaf placed by the target shardings, and ends bitwise
    where an uninterrupted run ends."""
    for r in g21:
        tr = r["trainers"]
        assert tr["resumed"] and tr["step_update"] == (30, 10)
        assert tr["on_mesh"] and tr["bitwise"]


def test_trainer_restores_with_target_shardings(g21):
    """test_checkpoint.py:46: Trainer.try_resume places params by the
    target shardings: 'w' [4, 4] over 'data' holds this rank's 2 rows."""
    for i, r in enumerate(g21):
        ok, (pl, local) = r["trainers"]["trainer_resumed"], \
            r["trainers"]["trainer_w"]
        assert ok and pl == "(Shard(dim=0), Replicate())"
        np.testing.assert_array_equal(
            local, np.arange(16.0, dtype=np.float32).reshape(4, 4)[
                2 * i:2 * i + 2])


# ---------------------------------------------------------------------------
# Compression, the loader, MoE expert parallelism
# ---------------------------------------------------------------------------

def test_compressed_psum_error_feedback(g12):
    """test_distribution.py:67 over a 2-rank 'pod' group: the accumulated
    update over 8 steps stays within 0.05 of the true mean's, two
    collectives a leaf a step.  With a g that differs a rank (1x, 2x) the
    accumulated update is the reference's own arithmetic (int32 sum of the
    codes times the largest scale over n), run here on its `_quant_int8`
    for the two ranks, within 1e-6 of its largest entry."""
    from repro.runtime.compression import _quant_int8
    base = np.linspace(-1.0, 1.0, 64, dtype=np.float32).reshape(8, 8)
    gs = [jnp.asarray(base * (1.0 + r)) for r in range(2)]
    errs = [jnp.zeros((8, 8)) for _ in range(2)]
    total = jnp.zeros((8, 8))
    for _ in range(8):
        xs = [g + e for g, e in zip(gs, errs)]
        qs, scales = zip(*(_quant_int8(x) for x in xs))
        qsum = sum(q.astype(jnp.int32) for q in qs)
        g_hat = qsum.astype(jnp.float32) * jnp.maximum(*scales) / 2.0
        errs = [x - q.astype(jnp.float32) * sc
                for x, q, sc in zip(xs, qs, scales)]
        total = total + g_hat
    want = np.asarray(total)
    for r in g12[1]:
        c = r["compression"]
        assert float(np.abs(c["same"]["total"] - 8 * base).max()) < 0.05
        assert float(np.abs(c["ranked"]["total"] - want).max()) \
            <= 1e-6 * float(np.abs(want).max())
        assert c["same"]["colls"] == {"all_reduce_sum": 8,
                                      "all_reduce_max": 8}


def test_sharded_host_loader(g12):
    """Batches in order, x split over 'data' (mesh (1, 2): each rank
    whole, a DTensor), y replicated (a plain tensor); a loader failure is
    raised at the batch where it happened; close() ends the thread."""
    for r in g12[1]:
        ld = r["loader"]
        assert len(ld["batches"]) == 5
        for i, b in enumerate(ld["batches"]):
            np.testing.assert_array_equal(
                b["x"], np.arange(16, dtype=np.float32).reshape(4, 4)
                + 100 * i)
            assert b["x_placements"] == "(Shard(dim=0), Replicate())"
            assert not b["y_dtensor"] and (b["y"] == i).all()
        assert ld["raised"] == "loader failure at batch 1"
        np.testing.assert_array_equal(
            ld["first"], np.arange(16, dtype=np.float32).reshape(4, 4))
        assert ld["closed"]


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_moe_shardmap_equals_dispatch(g12, g22, mesh, arch):
    """moe_block_shardmap at --smoke against dispatch on each rank's
    tokens, within the bf16 bound; bitwise run to run.  (1, 2): half the
    experts a rank, one all_reduce over 'model' of the output and none of
    the aux loss; (2, 2) with fsdp: the expert weights and router
    all-gathered over 'data' and the aux loss averaged over it."""
    for r in _groups(g12, g22)[mesh]:
        m = r["moe"][arch]
        scale = float(np.abs(m["y_shard_disp"]).max())
        assert float(np.abs(m["y"] - m["y_shard_disp"]).max()) \
            <= MOE_REL * scale
        assert m["bitwise"]
        if mesh == (1, 2):
            assert m["colls"] == {"all_reduce_sum": 1}
            np.testing.assert_array_equal(m["y_shard_disp"],
                                          m["y_disp_rows"])
            assert m["aux"] == pytest.approx(m["aux_disp"], rel=1e-6)
            assert m["placements"]["wi"] == "(Replicate(), Shard(dim=0))"
        else:
            assert m["colls"] == {"all_gather": 4, "all_reduce_sum": 2}
            assert m["placements"]["wi"] == "(Shard(dim=1), Shard(dim=0))"


def test_logical_constraint_redistributes_a_dtensor(g12):
    """models.module.logical_constraint on mesh (1, 2): a DTensor moves to
    the rules' placements (its 'mlp' dim split over 'model'), a plain
    tensor and a call without a mesh are left as they are."""
    whole = np.arange(32.0, dtype=np.float32).reshape(4, 8)
    for i, r in enumerate(g12[1]):
        c = r["constraint"]
        assert c["plain_same"] and c["no_mesh_same"]
        assert c["before"] == "(Shard(dim=0), Replicate())"
        assert c["after"] == "(Shard(dim=0), Shard(dim=1))"
        np.testing.assert_array_equal(c["local"], whole[:, 4 * i:4 * i + 4])


def test_collectives_over_two_mesh_dims(g22):
    """sharding's collectives over ('pod', 'data') of a (2, 2, 1) mesh:
    one group of the 4 ranks, gathered in pod-major order."""
    for r in g22:
        assert r["pod_data_sum"] == 10.0
        assert r["pod_data_rows"] == [0, 1, 2, 3]
