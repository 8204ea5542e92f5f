"""Atomic, async checkpoints of the port's trees, in the JAX package's
on-disk layout.

Counterpart of `repro.checkpoint.ckpt`.  One directory per step:

    <root>/step_00000123.tmp/          # written here first
        manifest.json                  # step, leaves [{name, shape, dtype,
                                       #   shards}], extra
        <leaf>.s_full.npy              # one file per leaf
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

The port runs on one device, so it writes whole leaves only (one
`s_full` file, `"index": null`).  Its reader still assembles a sharded
checkpoint of the JAX package from its shard files.  Placement by target
shardings (the JAX package's `shardings` argument, elastic re-mesh) is
not ported: ROADMAP Queue 1 item 13.

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


def _snapshot(tree: Tree) -> list:
    """[(name, host array, manifest dtype)] in the manifest's order."""
    return [(leaf_name(path), _to_host(leaf), dtype_name(leaf))
            for path, leaf in tree_flatten_with_path(tree)]


def _write(root: Path, step: int, snapshot: list, extra: dict | None) -> Path:
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for name, host, dtype in snapshot:
        fname = f"{name}.s_full.npy"
        np.save(tmp / fname, host)
        manifest["leaves"].append(
            {"name": name, "shape": list(host.shape), "dtype": dtype,
             "shards": [{"file": fname, "index": None}]})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomicity barrier
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


def _restore_leaf(name: str, entry: dict | None, like, ckpt_dir: Path):
    if entry is None:
        raise CheckpointError(f"checkpoint {ckpt_dir} has no leaf {name!r}")
    shape, dtype = tuple(np.shape(like)), dtype_name(like)
    if tuple(entry["shape"]) != shape or entry["dtype"] != dtype:
        raise CheckpointError(
            f"checkpoint {ckpt_dir} leaf {name!r} is {entry['dtype']}"
            f"{tuple(entry['shape'])}, expected {dtype}{shape}")
    host = _assemble(entry, ckpt_dir)
    if not isinstance(like, torch.Tensor):
        return host
    if dtype == BF16:
        t = torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(host)
    return t.to(like.device)


def load_checkpoint(root: str | Path, tree_like: Tree,
                    step: int | None = None):
    """Restore into the structure of `tree_like`; each leaf must have the
    name, shape and dtype of the corresponding leaf of `tree_like`
    (CheckpointError otherwise), and a tensor leaf lands on that leaf's
    device.  Returns (tree, step), or (None, -1) when `root` holds no
    valid step and none was named."""
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

    def restore(path, like):
        name = leaf_name(path)
        return _restore_leaf(name, by_name.get(name), like, ckpt_dir)

    return tree_map_with_path(restore, tree_like), step


class CheckpointManager:
    """Async checkpointing with retention.

    save() snapshots the tree to host numpy arrays in the caller's thread
    (the device-to-host copies happen there, so the caller may reuse the
    tensors' storage at once), then writes and renames on a background
    thread that touches numpy and files only, so the train loop never
    blocks on disk.

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

        if self.async_write:
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

    def restore(self, tree_like: Tree, step: int | None = None):
        self.wait()
        return load_checkpoint(self.root, tree_like, step)

    def _gc(self):
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
                 step: int | None = None):
    """Restore one session (the newest VALID step by default, with the
    fallback of `load_checkpoint`).  Returns (tree, step); raises
    CheckpointError if the session has no valid checkpoint."""
    sdir = _session_dir(root, sid)
    tree, got = load_checkpoint(sdir, tree_like, step)
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
