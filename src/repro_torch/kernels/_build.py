"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` exposes a plain C interface and is compiled by
nvcc, at first use, into a shared library under `build/repro_torch/` at the
repository root, named by a hash of the source and the flags — a changed
source builds anew, an unchanged one is reused.  The library is loaded with
ctypes; every pointer and the stream are passed as `c_void_p`.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu

`build(names)` starts one nvcc per source, all together, and waits for them;
a failed build raises with nvcc's stderr.  Nothing here runs at import.
`check_operand` is the operand check every kernel's wrapper makes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("compact_fused", "influence", "event_matmul", "wkv")

_I, _P = ctypes.c_int, ctypes.c_void_p
# C signatures: (argtypes, restype) of every exported function
SIGNATURES = {
    "compact_fused": {
        "repro_fused_update": ([_I] + [_P] * 9 + [_I] * 4 + [_P], _I),
        "repro_error_string": ([_I], ctypes.c_char_p),
    },
    "influence": {
        "repro_influence_update": ([_P] * 10 + [_I] * 3 + [_P], _I),
        "repro_error_string": ([_I], ctypes.c_char_p),
    },
    "event_matmul": {
        "repro_event_matmul": ([_P] * 6 + [_I] * 4 + [_P], _I),
        "repro_error_string": ([_I], ctypes.c_char_p),
    },
    "wkv": {
        "repro_wkv": ([_P] * 8 + [_I] * 6 + [_P], _I),
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
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
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
        cmd = [exe, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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
