"""The port's checkpoints (`repro_torch.checkpoint`): the JAX package's
unsharded checkpoint cases (tests/test_checkpoint.py) on the port's trees,
the bf16 encoding on disk, the load-time checks against `tree_like`, and
the manifest against the JAX package's on the same tree."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JCK
from repro_torch.checkpoint import (CheckpointError, CheckpointManager,
                                    load_checkpoint, save_checkpoint,
                                    valid_steps, validate_checkpoint_dir)
from repro_torch.tree import leaf_name, tree_flatten_with_path, tree_leaves


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"emb": {"tok": torch.randn(16, 8, generator=g)},
            "layers": [{"w": torch.randn(8, 8, generator=g),
                        "b": torch.zeros(8)}],
            "scalar": torch.tensor(3.5),
            "idx": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "half": torch.randn(4, 5, generator=g).to(torch.bfloat16),
            "host": np.array([0, seed], dtype=np.uint32),
            "dense": None}


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x.reshape(-1).view(torch.uint8),
                               y.reshape(-1).view(torch.uint8))
        else:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _failing_writer(n_failures):
    calls = {"n": 0}

    def write_fault(step):
        calls["n"] += 1
        if calls["n"] <= n_failures:
            raise OSError(f"injected write failure #{calls['n']}")

    return write_fault, calls


# ---------------------------------------------------------------------------
# the JAX package's unsharded cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("async_write", [False, True])
def test_roundtrip(tmp_path, async_write):
    cm = CheckpointManager(tmp_path, async_write=async_write)
    tree = _tree(0)
    cm.save(7, tree)
    out, step = cm.restore(_tree(1))
    assert step == 7
    _assert_trees_equal(out, tree)
    assert out["dense"] is None


def test_async_and_retention(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2, async_write=True)
    tree = _tree(1)
    for s in (1, 2, 3, 4):
        cm.save(s, tree)
    cm.wait()
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]
    assert cm.latest_step() == 4 and cm.last_saved == 4


def test_restore_missing_returns_none(tmp_path):
    cm = CheckpointManager(tmp_path)
    out, step = cm.restore({"a": torch.zeros(3)})
    assert out is None and step == -1


def test_atomicity_no_tmp_left(tmp_path):
    cm = CheckpointManager(tmp_path, async_write=False)
    cm.save(5, _tree(3))
    assert not list(tmp_path.glob("*.tmp"))
    assert valid_steps(tmp_path) == [5]


@pytest.mark.parametrize("surfaced", ["wait", "next_save", "sync"])
def test_write_failure_surfaces(tmp_path, surfaced):
    """A failed write is re-raised as CheckpointError: on wait() or the
    next save() when asynchronous, at once when synchronous; the manager
    is usable again afterwards."""
    wf, _ = _failing_writer(n_failures=10)
    cm = CheckpointManager(tmp_path, async_write=surfaced != "sync",
                           write_fault=wf)
    if surfaced == "sync":
        with pytest.raises(CheckpointError, match="step 1 failed"):
            cm.save(1, _tree(0))
    else:
        cm.save(1, _tree(0))
        with pytest.raises(CheckpointError, match="step 1 failed"):
            cm.wait() if surfaced == "wait" else cm.save(2, _tree(0))
    cm.write_fault = None
    cm.save(3, _tree(0))
    cm.wait()
    assert cm.latest_step() == 3


def test_write_retries_absorb_transient_fault(tmp_path):
    wf, calls = _failing_writer(n_failures=2)
    cm = CheckpointManager(tmp_path, async_write=True, retries=2,
                           retry_backoff_s=0.0, write_fault=wf)
    cm.save(3, _tree(0))
    cm.wait()                              # third attempt succeeded
    assert calls["n"] == 3
    assert cm.latest_step() == 3


def test_truncated_checkpoint_falls_back_to_previous_valid(tmp_path):
    cm = CheckpointManager(tmp_path, async_write=False)
    tree = _tree(1)
    cm.save(1, tree)
    cm.save(2, tree)
    (tmp_path / "step_00000002" / "manifest.json").unlink()
    assert valid_steps(tmp_path) == [1]
    assert cm.latest_step() == 1
    out, step = cm.restore(tree)
    assert step == 1 and out is not None


def test_missing_shard_detected(tmp_path):
    cm = CheckpointManager(tmp_path, async_write=False)
    tree = _tree(2)
    cm.save(1, tree)
    cm.save(2, tree)
    d = tmp_path / "step_00000002"
    next(iter(d.glob("*.npy"))).unlink()
    assert not validate_checkpoint_dir(d)
    assert cm.latest_step() == 1


@pytest.mark.parametrize("victim", ["emb__tok", "half", "idx"])
def test_shard_shape_dtype_mismatch_detected(tmp_path, victim):
    cm = CheckpointManager(tmp_path, async_write=False)
    tree = _tree(3)
    cm.save(1, tree)
    d = tmp_path / "step_00000001"
    np.save(d / f"{victim}.s_full.npy", np.zeros((2, 2), np.float16))
    assert not validate_checkpoint_dir(d)
    assert cm.latest_step() == -1
    out, step = cm.restore(tree)
    assert out is None and step == -1


def test_explicit_corrupt_step_raises_checkpoint_error(tmp_path):
    cm = CheckpointManager(tmp_path, async_write=False)
    tree = _tree(4)
    cm.save(1, tree)
    (tmp_path / "step_00000001" / "manifest.json").unlink()
    with pytest.raises(CheckpointError, match="missing or corrupt"):
        load_checkpoint(tmp_path, tree, step=1)


# ---------------------------------------------------------------------------
# the bf16 encoding, and the load-time checks
# ---------------------------------------------------------------------------

def test_bf16_leaf_roundtrips_bitwise_as_uint16_bits(tmp_path):
    g = torch.Generator().manual_seed(5)
    vals = torch.randn(3, 4, 7, generator=g).to(torch.bfloat16)
    vals[0, 0, :3] = torch.tensor([float("inf"), -0.0, 1e-40])
    save_checkpoint(tmp_path, 0, {"vals": vals})
    d = tmp_path / "step_00000000"
    entry = json.loads((d / "manifest.json").read_text())["leaves"][0]
    assert entry["dtype"] == "bfloat16" and entry["shape"] == [3, 4, 7]
    raw = np.load(d / "vals.s_full.npy")
    assert raw.dtype == np.dtype("<u2")
    np.testing.assert_array_equal(raw, vals.view(torch.int16).numpy()
                                  .view(np.uint16))
    out, _ = load_checkpoint(tmp_path, {"vals": torch.zeros_like(vals)})
    assert out["vals"].dtype == torch.bfloat16
    assert torch.equal(out["vals"].view(torch.int16), vals.view(torch.int16))


@pytest.mark.parametrize("writer", ["manager", "sharded"])
def test_reference_bf16_void_file_loads_bitwise(tmp_path, writer):
    """The JAX package writes a bf16 leaf through ml_dtypes ('<V2' on
    disk, manifest dtype "bfloat16"); its own validator rejects that file,
    the port's reads it.  Its manager writes host arrays whole (s_full);
    its save_checkpoint on device arrays writes shard files with an index,
    which the port assembles."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 3, 5)).astype(np.float32)
    tree = {"carry": {"vals": jnp.asarray(a, dtype=jnp.bfloat16)},
            "w": jnp.asarray(a[0])}
    if writer == "manager":
        JCK.CheckpointManager(tmp_path, async_write=False).save(4, tree)
    else:
        JCK.save_checkpoint(tmp_path, 4, tree)
    d = tmp_path / "step_00000004"
    entry = json.loads((d / "manifest.json").read_text())["leaves"][0]
    assert entry["name"] == "carry__vals" and entry["dtype"] == "bfloat16"
    assert (entry["shards"][0]["index"] is None) == (writer == "manager")
    assert np.load(d / entry["shards"][0]["file"]).dtype.kind == "V"
    assert not JCK.validate_checkpoint_dir(d)
    assert validate_checkpoint_dir(d) and valid_steps(tmp_path) == [4]
    like = {"carry": {"vals": torch.zeros(2, 3, 5, dtype=torch.bfloat16)},
            "w": torch.zeros(3, 5)}
    out, step = load_checkpoint(tmp_path, like)
    assert step == 4
    want = torch.from_numpy(a).to(torch.bfloat16)    # round to nearest even
    assert torch.equal(out["carry"]["vals"].view(torch.int16),
                       want.view(torch.int16))
    assert torch.equal(out["w"], torch.from_numpy(a[0]))


@pytest.mark.parametrize("like,match", [
    ({"w": torch.zeros(4, 3), "n": torch.zeros((), dtype=torch.int32)},
     r"'w' is float32\(3, 4\), expected float32\(4, 3\)"),
    ({"w": torch.zeros(3, 4, dtype=torch.bfloat16),
      "n": torch.zeros((), dtype=torch.int32)},
     r"'w' is float32\(3, 4\), expected bfloat16\(3, 4\)"),
    ({"w": torch.zeros(3, 4), "n": torch.zeros(())},
     r"'n' is int32\(\), expected float32\(\)"),
    ({"w": torch.zeros(3, 4), "n": torch.zeros((), dtype=torch.int32),
      "extra": torch.zeros(2)}, "no leaf 'extra'"),
])
def test_restore_checks_each_leaf_against_tree_like(tmp_path, like, match):
    save_checkpoint(tmp_path, 1, {"w": torch.ones(3, 4),
                                  "n": torch.tensor(7, dtype=torch.int32)})
    with pytest.raises(CheckpointError, match=match):
        load_checkpoint(tmp_path, like)


def test_restore_places_leaves_like_tree_like(tmp_path):
    tree = {"t": torch.ones(2, 2), "h": np.int32(5), "k": np.arange(2,
                                                                dtype=np.uint32)}
    save_checkpoint(tmp_path, 2, tree)
    out, _ = load_checkpoint(tmp_path, {"t": torch.zeros(2, 2),
                                        "h": np.int32(0),
                                        "k": np.zeros(2, np.uint32)})
    assert isinstance(out["t"], torch.Tensor) and out["t"].device.type == "cpu"
    assert isinstance(out["h"], np.ndarray) and out["h"].shape == ()
    assert int(out["h"]) == 5 and out["k"].dtype == np.uint32


def test_snapshot_is_a_copy_taken_at_save(tmp_path):
    """save() copies to the host before it returns: writing the tensor in
    place afterwards does not reach the checkpoint."""
    t = torch.zeros(64, 64)
    cm = CheckpointManager(tmp_path, async_write=True)
    cm.save(1, {"t": t})
    t.fill_(1.0)
    cm.wait()
    out, _ = cm.restore({"t": torch.empty(64, 64)})
    assert float(out["t"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the manifest against the JAX package's
# ---------------------------------------------------------------------------

def test_leaf_names_and_order_match_jax_flattening():
    tree = {"z": [1, {"b": 2, "a": None}], "a": {"y": 3, "x": (4, 5)},
            "m": None, "k": 6}
    jleaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    ours = tree_flatten_with_path(tree)
    assert [leaf_name(p) for p, _ in ours] == \
        [JCK._leaf_name(p) for p, _ in jleaves]
    assert [v for _, v in ours] == [v for _, v in jleaves]
    assert leaf_name(()) == JCK._leaf_name(()) == "leaf"


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    tree = _tree(6)
    del tree["half"], tree["dense"]
    save_checkpoint(tmp_path, 3, tree)
    jlike = {"emb": {"tok": jnp.zeros((16, 8))},
             "layers": [{"w": jnp.zeros((8, 8)), "b": jnp.zeros((8,))}],
             "scalar": jnp.float32(0), "idx": jnp.zeros((2, 3), jnp.int32),
             "host": jnp.zeros(2, jnp.uint32)}
    assert JCK.valid_steps(tmp_path) == [3]
    out, step = JCK.load_checkpoint(tmp_path, jlike)
    assert step == 3
    for a, (_, b) in zip(jax.tree.leaves(out), tree_flatten_with_path(tree)):
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
