"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` exposes a plain C interface and is compiled by
nvcc, at first use, into a shared library under `build/repro_torch/` at the
repository root, named by a hash of the source and the flags — a changed
source builds anew, an unchanged one is reused.  The library is loaded with
ctypes, with `argtypes` set.  All four kernels (K1-K4) take their launch
arguments packed in one buffer of 64-bit ints (`KernelCall.launch`): one
argument for ctypes to convert instead of 11 to 15.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu \\
         -lcuda

`build(names)` starts one nvcc per source, all together, and waits for them;
a failed build raises with nvcc's stderr.  Nothing here runs at import.
`KernelCall` checks a kernel's operands in one comparison per operand
(`check_operand` gives the reason where one differs), and
`KernelCall.launch` keeps the rest of the launch path light: the device
entered only when it is not current, the raw stream handle, the arguments
packed.  `refuse_autograd` is the check every wrapper makes
before a launch: the kernels have no backward.

The slot fold (`fold`, `is_transformed`): the stream fleet
(`runtime.fleet`) runs its sessions' update chunk under `torch.func.vmap`,
one slot a session.  A tensor there has no storage of its own, so a wrapper
that launches from raw data pointers (K1, `compact_fused.fused_update`; K2,
`influence.influence_update`) cannot run on it.  Both kernels take a batch
of examples and the slots differ only in their examples, so the wrapper
hands such a call to `fold`: an autograd.Function whose vmap rule folds the
slot axis into the example axis ([S, B, ...] -> [S*B, ...]), calls the
wrapper once on plain tensors and unfolds its output.  Operands that every
slot shares (K2's constant block masks and its block counter) pass through
unfolded; a batched one raises.  On the CPU the wrapper runs its plain
version on the folded operands, so the CPU tests walk the same fold.  The
wrapper looks for a vmapped slot only where an unbatched call never goes:
where the operands differ from the last call's, and where a data pointer
cannot be read (a slot has no storage, and its shapes can match).  So an
unbatched call pays nothing for the route.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import time
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIBS = ("-lcuda",)   # the driver API (csrc/driver_launch.cuh); after the source
KERNELS = ("compact_fused", "influence", "event_matmul", "wkv")

_I, _P = ctypes.c_int, ctypes.c_void_p
# C signatures: (argtypes, restype) of every exported function
SIGNATURES = {
    # every launch takes its arguments packed in one buffer (`KernelCall`)
    "compact_fused": {
        "repro_fused_update": ([ctypes.c_char_p], _I),
        "repro_fused_geometry": ([_I] * 2 + [ctypes.POINTER(ctypes.c_longlong)],
                                 _I),
        "repro_error_string": ([_I], ctypes.c_char_p),
    },
    "influence": {
        "repro_influence_update": ([ctypes.c_char_p], _I),
        "repro_empty_launch": ([ctypes.c_char_p], _I),
        "repro_error_string": ([_I], ctypes.c_char_p),
    },
    "event_matmul": {
        "repro_event_matmul": ([ctypes.c_char_p], _I),
        "repro_error_string": ([_I], ctypes.c_char_p),
    },
    "wkv": {
        "repro_wkv": ([ctypes.c_char_p], _I),
        "repro_wkv_geometry": ([_I] * 4 + [ctypes.POINTER(ctypes.c_longlong)],
                               _I),
        "repro_error_string": ([_I], ctypes.c_char_p),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}      # name -> nvcc's stderr (ptxas -v report)


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH): "
                           "the port's kernels are built from source")
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers (csrc/*.cuh) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=KERNELS) -> float:
    """Compile every named kernel whose library is missing, one nvcc each,
    all at once.  Returns the wall seconds spent; raises on a failed build."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"), *LIBS]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        build_log[name] = out + err
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"error {err}: {lib.repro_error_string(err).decode()}"


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise where grad mode is on and an operand requires grad.  A kernel
    fills its outputs through ctypes, so they carry no grad_fn, and none has
    a backward: a loss through it would silently miss its gradient."""
    if torch.is_grad_enabled():
        for t in tensors:
            if t.requires_grad:
                raise RuntimeError(
                    f"{kernel}: an operand requires grad, and the CUDA kernel "
                    "has no backward: call under torch.no_grad() or use the "
                    "plain version")


def check_operand(kernel: str, name: str, t, dtypes, shape, device) -> None:
    """Raise unless tensor `t` has one of `dtypes`, `shape`, is contiguous
    and lies on `device`: what a kernel's pointer arithmetic assumes."""
    if t.dtype not in dtypes:
        raise TypeError(f"{kernel}: {name} must be "
                        f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")


def contiguous_strides(shape) -> tuple:
    """The strides torch gives a contiguous tensor of `shape`."""
    strides, step = [], 1
    for d in reversed(shape):
        strides.append(step)
        step *= max(d, 1)
    return tuple(reversed(strides))


_get_device = (getattr(torch._C, "_cuda_getDevice", None)
               or torch.cuda.current_device)
_raw_stream = (getattr(torch._C, "_cuda_getCurrentRawStream", None)
               or (lambda index: torch.cuda.current_stream(index).cuda_stream))


def current_stream(device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device."""
    index = device.index
    return _raw_stream(_get_device() if index is None else index)


class KernelCall:
    """One kernel's launch at one set of shapes, built once per shape.

    `entries` say what each operand must be: (name, dtype, allowed dtypes,
    shape), contiguous, on `device`.  `matches` compares one (dtype, shape,
    stride, device) tuple per tensor with the expected ones; `check` raises
    with the reason where one differs, through `check_operand` (a tensor
    whose size-1 dims carry other strides is still contiguous, and passes).
    `launch(*ptrs)` calls the entry point `fn` of library `lib` on the
    `n_ptrs` pointers, then `dims`, then the current stream, packed as
    64-bit ints, with the device entered only when it is not current; it
    raises if the launch fails.  `out_like`, if given, is a tensor shaped
    like the output, for `torch.empty_like` (the cheapest allocation call)."""

    def __init__(self, kernel: str, device, entries, lib, fn, dims, n_ptrs,
                 out_like=None):
        self.kernel, self.device, self.entries = kernel, device, entries
        self.lib, self.fn, self.dims = lib, fn, tuple(dims)
        self.out_like = out_like
        self.want = [(dtype, torch.Size(shape), contiguous_strides(shape),
                      device) for _, dtype, _, shape in entries]
        self.pack = struct.Struct(f"{n_ptrs + len(self.dims) + 1}Q").pack

    def matches(self, tensors) -> bool:
        return [(t.dtype, t.shape, t.stride(), t.device)
                for t in tensors] == self.want

    def check(self, tensors) -> None:
        if not self.matches(tensors):
            for (name, _, allowed, shape), t in zip(self.entries, tensors):
                check_operand(self.kernel, name, t, allowed, shape,
                              self.device)

    def launch(self, *ptrs: int) -> None:
        index = self.device.index
        if index == _get_device():
            err = self.fn(self.pack(*ptrs, *self.dims, _raw_stream(index)))
        else:
            with torch.cuda.device(self.device):
                err = self.fn(self.pack(*ptrs, *self.dims,
                                        current_stream(self.device)))
        if err != 0:
            raise RuntimeError(f"{self.kernel}: kernel launch failed: "
                               f"{error_string(self.lib, err)}")


# ---------------------------------------------------------------------------
# The slot fold
# ---------------------------------------------------------------------------

def is_transformed(t: torch.Tensor) -> bool:
    """True for a tensor wrapped by a `torch.func` transform (a slot of a
    vmapped fleet, say): it has no storage of its own and its values cannot
    steer the host."""
    return torch._C._functorch.is_functorch_wrapped_tensor(t)


class _Fold(torch.autograd.Function):
    """fn(*args), with a vmap rule that calls fn once for every slot."""
    generate_vmap_rule = False

    @staticmethod
    def forward(fn, shared, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, fn, shared, *args):
        S = info.batch_size
        folded = []
        for i, (a, d) in enumerate(zip(args, in_dims[2:])):
            if a is None or i in shared:
                if d is not None:
                    raise ValueError(
                        f"{fn.__name__}: operand {i} is shared by every "
                        "slot of the fold and cannot differ between slots")
                folded.append(a)
                continue
            a = a.expand(S, *a.shape) if d is None else a.movedim(d, 0)
            folded.append(a.reshape(S * a.shape[1], *a.shape[2:])
                          .contiguous())
        out = fn(*folded)
        return out.reshape(S, out.shape[0] // S, *out.shape[1:]), 0


def fold(fn: Callable, args: tuple, shared: tuple = ()):
    """fn(*args) under `torch.func.vmap`, as one call of fn on the operands
    with the slot axis folded into their leading (example) axis; `shared`
    names the positions of operands that every slot shares."""
    return _Fold.apply(fn, shared, *args)
