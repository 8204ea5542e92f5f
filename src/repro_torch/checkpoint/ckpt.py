"""Atomic, async checkpoints of the port's trees, in the JAX package's
on-disk layout.

Counterpart of `repro.checkpoint.ckpt`.  One directory per step:

    <root>/step_00000123.tmp/          # written here first
        manifest.json                  # step, leaves [{name, shape, dtype,
                                       #   shards}], extra
        <leaf>.s_full.npy              # a whole leaf, or
        <leaf>.s<index tag>.npy        # one file a shard of a placed leaf
    <root>/step_00000123/              # atomic rename on completion

Leaves are named as the JAX package names them (`tree.leaf_name`: dict
keys in sorted order and list indices, joined by '__'), so a tree of the
port and the same tree of the JAX package give the same manifest.  A leaf
is a torch tensor (restored to the device of the corresponding leaf of
`tree_like`) or a numpy array (restored as one).

Leaf dtypes on disk.  float32, int32 and every other numpy dtype are
written as themselves, and the manifest's dtype must match the file's
exactly.  numpy has no bfloat16: a torch.bfloat16 leaf is written as its
raw bits, a '<u2' (uint16) array, under the manifest dtype "bfloat16".
For a "bfloat16" entry the reader accepts a uint16 file or a 2-byte void
file ('<V2' / '|V2', what the JAX package writes through ml_dtypes) and
reinterprets the bits as torch.bfloat16.

Sharded writes.  A DTensor leaf (`sharding.place`) is written shard by
shard: each rank writes the shards it holds, one file each, named and
indexed as the JAX package names them (`<leaf>.s0-4_0-e.npy`, `"index":
[[0, 4], [null, null]]`, null where the dim is not split), and a shard
held by several ranks (replicated over a mesh dim) is written once, by
the rank at coordinate 0 of those dims.  A placement that is a partial
sum (the sharded scaled learner's gradient accumulators) is summed first
(one all_reduce over its mesh dims).  A plain tensor or numpy leaf is
whole on every rank and rank 0 writes it as one `s_full` file.  In a
process group of several ranks rank 0 makes the directory, every rank
writes, and after a barrier rank 0 writes the manifest (every rank's
shard list follows from the placements and the mesh) and renames; the
group then meets at a second barrier, so every rank returns with the
step on disk.

Elastic re-mesh.  `load_checkpoint(root, tree_like, shardings)` assembles
each leaf on the host from its files (whole, or the shards of any mesh,
the JAX package's included) and places a tensor leaf by its TARGET
sharding (`models.module.NamedSharding`, possibly over a mesh of another
shape): this rank's slice on the mesh's device, with no collective.
Without a sharding a tensor leaf lands on the device of the
corresponding leaf of `tree_like`; a numpy leaf (host state: a stream
position, a key) is restored as numpy either way.

The session-keyed store of the stream fleet (`save_session`,
`load_session`, `list_sessions`) keeps one checkpoint lineage a session
under `<root>/session/<sid>/step_*`, the JAX package's layout, so a session
either package evicted resumes in the other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.tree import leaf_name, tree_flatten_with_path, tree_map_with_path

Tree = Any
BF16 = "bfloat16"


class CheckpointError(RuntimeError):
    """A checkpoint could not be written (async write failed after retries)
    or restored (requested step missing or corrupt, or a leaf that does not
    fit `tree_like`).  Retryable by `run_with_restart`'s default policy."""


def _file_dtype_ok(want: str, fdtype: np.dtype) -> bool:
    if want == BF16 and (fdtype == np.uint16
                         or (fdtype.kind == "V" and fdtype.itemsize == 2)):
        return True
    return str(fdtype) == want


def _npy_header(path: Path):
    """(shape, dtype) from an .npy header without reading the payload."""
    arr = np.load(path, mmap_mode="r")
    return tuple(arr.shape), arr.dtype


def validate_checkpoint_dir(ckpt_dir: str | Path) -> bool:
    """True iff the directory is a complete, consistent checkpoint: the
    manifest parses and every shard file exists with the manifest's dtype
    (bf16 as above) and extent (headers only).  Catches interrupted writes
    and gc, deleted shards and truncated files."""
    ckpt_dir = Path(ckpt_dir)
    try:
        manifest = json.loads((ckpt_dir / "manifest.json").read_text())
        for entry in manifest["leaves"]:
            shape = tuple(entry["shape"])
            for sh in entry["shards"]:
                fshape, fdtype = _npy_header(ckpt_dir / sh["file"])
                if not _file_dtype_ok(entry["dtype"], fdtype):
                    return False
                if sh["index"] is None:
                    want = shape
                else:
                    want = tuple(
                        (b if b is not None else shape[d]) - (a or 0)
                        for d, (a, b) in enumerate(sh["index"]))
                if fshape != want:
                    return False
    except (OSError, ValueError, KeyError, TypeError,
            json.JSONDecodeError):
        return False
    return True


def valid_steps(root: str | Path) -> list:
    """Steps under `root` whose checkpoint directories validate, ascending."""
    out = []
    for p in Path(root).glob("step_*"):
        if p.name.endswith(".tmp"):
            continue
        try:
            s = int(p.name.split("_")[1])
        except ValueError:
            continue
        if validate_checkpoint_dir(p):
            out.append(s)
    return sorted(out)


def dtype_name(leaf) -> str:
    """The manifest's dtype string: numpy's name ("float32", "int32", ...;
    "bfloat16" for torch.bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _to_host(leaf) -> np.ndarray:
    """A copy of the leaf on the host, as numpy (bf16 as its uint16 bits).
    Always a copy: a CPU tensor's storage may be reused by the next step."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf, copy=True)


def _group_ranks() -> tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _idx_tag(index) -> str:
    return "_".join(f"{a or 0}-{'e' if b is None else b}" for a, b in index)


def _shard_entries(leaf) -> tuple:
    """A DTensor leaf's shards: ([(index, file tag)] of every distinct
    shard on the mesh, the index of this rank's shard or None where
    another rank writes it, and the local value (partial sums summed))."""
    from torch.distributed.tensor import Partial, Replicate
    from repro_torch.sharding import all_reduce, local_index
    mesh, pl = leaf.device_mesh, tuple(leaf.placements)
    local = leaf.to_local()
    partial = [mesh.mesh_dim_names[i] for i, p in enumerate(pl)
               if isinstance(p, Partial)]
    if partial:
        local = all_reduce(local, mesh, tuple(partial))
    dup = [i for i, p in enumerate(pl) if isinstance(p, (Replicate, Partial))]

    def index_of(coord):
        idx = local_index(leaf.shape, pl, coord, mesh.shape)
        return [[None, None] if (sl.start, sl.stop) == (0, n)
                else [sl.start, sl.stop] for sl, n in zip(idx, leaf.shape)]

    shards = {}
    for coord in np.ndindex(*mesh.shape):
        if all(coord[i] == 0 for i in dup):
            index = index_of(coord)
            shards[_idx_tag(index)] = index
    coord = mesh.get_coordinate()
    mine = index_of(coord) if all(coord[i] == 0 for i in dup) else None
    return sorted(shards.items()), mine, local


def _snapshot(tree: Tree) -> list:
    """[(name, host array or None, manifest dtype, shape, shards)] in the
    manifest's order: `shards` None for a whole leaf (host: the leaf),
    else [(tag, index)] of every shard, host being this rank's shard or
    None where another rank writes it."""
    from torch.distributed.tensor import DTensor
    out = []
    for path, leaf in tree_flatten_with_path(tree):
        name, dtype = leaf_name(path), dtype_name(leaf)
        if isinstance(leaf, DTensor):
            shards, mine, local = _shard_entries(leaf)
            host = None if mine is None else (_idx_tag(mine), _to_host(local))
            out.append((name, host, dtype, tuple(leaf.shape), shards))
        else:
            host = _to_host(leaf)
            out.append((name, host, dtype, host.shape, None))
    return out


def _write(root: Path, step: int, snapshot: list, extra: dict | None) -> Path:
    from repro_torch.sharding import barrier
    rank, world = _group_ranks()
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if rank == 0:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    barrier()
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for name, host, dtype, shape, shards in snapshot:
        if shards is None:
            fname = f"{name}.s_full.npy"
            if rank == 0:
                np.save(tmp / fname, host)
            entries = [{"file": fname, "index": None}]
        else:
            if host is not None:
                np.save(tmp / f"{name}.s{host[0]}.npy", host[1])
            entries = [{"file": f"{name}.s{tag}.npy", "index": index}
                       for tag, index in shards]
        manifest["leaves"].append(
            {"name": name, "shape": list(shape), "dtype": dtype,
             "shards": entries})
    barrier()
    if rank == 0:
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomicity barrier
    barrier()
    return final


def save_checkpoint(root: str | Path, step: int, tree: Tree,
                    extra: dict | None = None) -> Path:
    """Atomic checkpoint write.  Returns the final directory path."""
    return _write(Path(root), step, _snapshot(tree), extra)


def _assemble(entry: dict, ckpt_dir: Path) -> np.ndarray:
    """The leaf's whole array (bf16 as uint16 bits), from one s_full file
    or from the shards of a sharded checkpoint."""
    bf16 = entry["dtype"] == BF16
    shards = entry["shards"]
    if len(shards) == 1 and shards[0]["index"] is None:
        arr = np.load(ckpt_dir / shards[0]["file"])
        return arr.view(np.uint16) if bf16 else arr
    out = np.zeros(tuple(entry["shape"]),
                   dtype=np.uint16 if bf16 else entry["dtype"])
    for sh in shards:
        idx = tuple(slice(a, b) for a, b in sh["index"])
        part = np.load(ckpt_dir / sh["file"])
        out[idx] = part.view(np.uint16) if bf16 else part
    return out


def _restore_leaf(name: str, entry: dict | None, like, ckpt_dir: Path,
                  sharding=None):
    if entry is None:
        raise CheckpointError(f"checkpoint {ckpt_dir} has no leaf {name!r}")
    shape, dtype = tuple(np.shape(like)), dtype_name(like)
    if tuple(entry["shape"]) != shape or entry["dtype"] != dtype:
        raise CheckpointError(
            f"checkpoint {ckpt_dir} leaf {name!r} is {entry['dtype']}"
            f"{tuple(entry['shape'])}, expected {dtype}{shape}")
    host = _assemble(entry, ckpt_dir)
    if not isinstance(like, torch.Tensor):
        return host                # host state (numpy) stays on the host
    if dtype == BF16:
        t = torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(host)
    if sharding is not None:
        from repro_torch.sharding import place
        return place(t, sharding)
    return t.to(like.device)


def load_checkpoint(root: str | Path, tree_like: Tree,
                    shardings: Tree | None = None, step: int | None = None):
    """Restore into the structure of `tree_like`; each leaf must have the
    name, shape and dtype of the corresponding leaf of `tree_like`
    (CheckpointError otherwise).  With `shardings` (a tree of
    `NamedSharding` over the same leaves, on any mesh) each leaf is placed
    by its target sharding (`sharding.place`); otherwise a tensor leaf
    lands on that leaf's device.  Returns (tree, step), or (None, -1) when
    `root` holds no valid step and none was named."""
    root = Path(root)
    if step is None:
        # newest VALID step: an interrupted write or gc leaves a directory
        # missing its manifest or shards; fall back to the previous one
        steps = valid_steps(root)
        if not steps:
            return None, -1
        step = steps[-1]
    ckpt_dir = root / f"step_{step:08d}"
    if not validate_checkpoint_dir(ckpt_dir):
        raise CheckpointError(
            f"checkpoint step {step} at {root} is missing or corrupt "
            "(manifest/shard validation failed)")
    manifest = json.loads((ckpt_dir / "manifest.json").read_text())
    by_name = {e["name"]: e for e in manifest["leaves"]}

    sh_by_path = (dict(tree_flatten_with_path(shardings))
                  if shardings is not None else {})

    def restore(path, like):
        name = leaf_name(path)
        return _restore_leaf(name, by_name.get(name), like, ckpt_dir,
                             sh_by_path.get(path))

    return tree_map_with_path(restore, tree_like), step


class CheckpointManager:
    """Async checkpointing with retention.

    save() snapshots the tree to host numpy arrays in the caller's thread
    (the device-to-host copies happen there, so the caller may reuse the
    tensors' storage at once), then writes and renames on a background
    thread that touches numpy and files only, so the train loop never
    blocks on disk.  In a process group of several ranks the write runs
    in the caller's thread: its barriers are collectives, which must not
    interleave with the train loop's.

    A write failure on the background thread is captured and re-raised as
    CheckpointError on the next save() or wait().  `retries` write
    attempts with exponential backoff absorb transient filesystem faults;
    `write_fault(step)` is a fault-injection seam called before each
    attempt."""

    def __init__(self, root: str | Path, keep: int = 3,
                 async_write: bool = True, retries: int = 0,
                 retry_backoff_s: float = 0.05, write_fault=None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        self.write_fault = write_fault
        self._thread: threading.Thread | None = None
        self._error: CheckpointError | None = None
        self.last_saved = -1

    def save(self, step: int, tree: Tree, extra: dict | None = None):
        self.wait()                       # also surfaces a prior failure
        snapshot = _snapshot(tree)

        def work():
            err = None
            for attempt in range(self.retries + 1):
                try:
                    if self.write_fault is not None:
                        self.write_fault(step)
                    _write(self.root, step, snapshot, extra)
                    self._gc()
                    self.last_saved = step
                    return
                except Exception as e:      # noqa: BLE001 — surfaced below
                    err = e
                    if attempt < self.retries:
                        time.sleep(self.retry_backoff_s * (2 ** attempt))
            ce = CheckpointError(
                f"checkpoint write for step {step} failed after "
                f"{self.retries + 1} attempt(s): {err!r}")
            ce.__cause__ = err
            self._error = ce

        if self.async_write and _group_ranks()[1] == 1:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_pending()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, tree_like: Tree, shardings: Tree | None = None,
                step: int | None = None):
        self.wait()
        return load_checkpoint(self.root, tree_like, shardings, step)

    def _gc(self):
        if _group_ranks()[0] != 0:
            return
        steps = sorted(p for p in self.root.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for p in steps[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    def latest_step(self) -> int:
        """Newest step whose directory validates (a half-written or
        gc-truncated directory does not shadow a good older one)."""
        steps = valid_steps(self.root)
        return steps[-1] if steps else -1


# ---------------------------------------------------------------------------
# Session-keyed store: per-session namespacing for the stream fleet
# ---------------------------------------------------------------------------
#
# A StreamFleet (runtime/fleet.py) evicts idle sessions — full {carry, opt
# state, stream position} trees — and resumes them bit for bit later,
# possibly into another slot or another process.  Each session gets its own
# checkpoint lineage under `<root>/session/<sid>/`, on the atomic write and
# the validation above: a truncated eviction write falls back to the
# session's previous valid state instead of poisoning the resume.

_SID_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")


def _session_dir(root: str | Path, sid: str) -> Path:
    """`<root>/session/<sid>` with the sid validated as a single path
    component — a sid like '../step_0' must not escape the namespace."""
    if not sid or any(c not in _SID_OK for c in sid) or sid in (".", ".."):
        raise ValueError(
            f"invalid session id {sid!r}: use [A-Za-z0-9._-]+ (a single "
            "path component)")
    return Path(root) / "session" / sid


def save_session(root: str | Path, sid: str, tree: Tree, step: int = 0,
                 extra: dict | None = None) -> Path:
    """Atomically persist one session's state under its own namespace.
    `step` keys the lineage (the fleet uses the session's update count), so
    repeated evictions of the same session keep their history like any
    other checkpoint root."""
    return save_checkpoint(_session_dir(root, sid), step, tree, extra)


def load_session(root: str | Path, sid: str, tree_like: Tree,
                 shardings: Tree | None = None, step: int | None = None):
    """Restore one session (the newest VALID step by default, with the
    fallback of `load_checkpoint`).  Returns (tree, step); raises
    CheckpointError if the session has no valid checkpoint."""
    sdir = _session_dir(root, sid)
    tree, got = load_checkpoint(sdir, tree_like, shardings, step)
    if tree is None:
        raise CheckpointError(
            f"session {sid!r} has no valid checkpoint under {sdir}")
    return tree, got


def list_sessions(root: str | Path) -> list:
    """Session ids under `root` that have at least one VALID checkpoint,
    sorted — the fleet's resumable population."""
    base = Path(root) / "session"
    if not base.is_dir():
        return []
    return sorted(p.name for p in base.iterdir()
                  if p.is_dir() and valid_steps(p))
