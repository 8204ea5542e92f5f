"""Package hygiene of the port: `repro_torch` imports neither `jax` nor
anything of `repro`, builds no kernel at import, and its entry points run
on the CPU only when asked."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
# every module the port has so far
EXPECTED = {
    "configs", "configs.base", "configs.egru_spiral", "configs.rwkv6_3b",
    "configs.gemma2_2b", "configs.qwen3_8b", "configs.yi_6b",
    "configs.minitron_8b", "configs.internvl2_2b", "models.attention",
    "configs.olmoe_1b_7b", "configs.kimi_k2_1t_a32b",
    "configs.recurrentgemma_9b", "models.moe", "models.rglru",
    "configs.whisper_large_v3", "models.encdec", "core.scaled_rtrl",
    "optim.grad", "optim.schedules", "launch.steps", "launch.costing",
    "launch.dryrun", "launch.dryrun_all", "launch.dryrun_lib",
    "cells", "cells.egru", "cells.rglru", "cells.snn", "checkpoint",
    "checkpoint.ckpt", "core.bptt", "core.cells", "core.costs",
    "core.diag_rtrl", "core.learner", "core.rtrl", "core.snap",
    "core.sparse_rtrl", "core.stacked_rtrl",
    "data.spiral", "data.tokens", "device",
    "kernels._build", "kernels.compact", "kernels.compact_fused",
    "kernels.event_matmul", "kernels.influence", "kernels.ops", "kernels.ref",
    "kernels.wkv", "launch.serve", "launch.train", "models", "models.layers",
    "models.module", "models.rwkv", "models.transformer", "obs", "obs.cli",
    "obs.events", "obs.metricpack", "obs.registry", "obs.summary",
    "obs.telemetry", "obs.trace", "obs.validate", "optim.optimizers",
    "runtime.guard", "runtime.online", "runtime.serving", "runtime.trainer",
    "sparsity", "sparsity.migrate", "sparsity.schedule", "tree", "weights",
}


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'
             or m == 'repro' or m.startswith('repro.'))
print(len(names), bad, ' '.join(names))
assert not bad, bad
from repro_torch.kernels import _build
assert not _build._loaded, 'a kernel was built or loaded at import'
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    words = r.stdout.split()
    names = {w.removeprefix("repro_torch.") for w in words[2:]}
    assert int(words[0]) == len(names) >= len(EXPECTED)
    assert EXPECTED <= names, sorted(EXPECTED - names)


def test_package_mirrors_reference_module_paths():
    import repro_torch
    ported = {m.name.replace("repro_torch.", "repro.", 1)
              for m in pkgutil.walk_packages(repro_torch.__path__,
                                             "repro_torch.")}
    own = {"repro.device", "repro.tree", "repro.weights",
           "repro.kernels._build"}
    for name in sorted(ported - own):
        rel = Path(*name.split("."))
        assert (SRC / rel).is_dir() or (SRC / rel.with_suffix(".py")).is_file(), \
            f"{name} has no counterpart in the JAX package"


def test_entry_point_raises_without_cuda():
    """`python -m repro_torch.launch.train` with no --device needs a card:
    without one it raises instead of running on the CPU."""
    code = """
import torch
torch.cuda.is_available = lambda: False
from repro_torch.launch import train
try:
    train.main(['--arch', 'egru-spiral', '--online', '--sparsity', '0.8',
                '--steps', '1'])
except RuntimeError as e:
    print('raised:', e)
else:
    raise SystemExit('ran without CUDA')
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "raised: CUDA is not available" in r.stdout


def test_resolve_device_only_cpu_when_named(monkeypatch):
    import torch
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(dev)
