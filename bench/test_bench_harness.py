"""The harness driven end to end on the CPU at a small width: a sound run is
correct, the control and every fault the cell can have are not, a new mix
and a new metric are found by name, and nothing the benchmark loads is JAX
or the JAX package.  One test runs the real cell on a card and skips
without one."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench import generator, run as R
from bench.systems import scaled_online as S

ROOT = Path(__file__).resolve().parents[1]
CELL = "scaled-n1024-k1024.dense-act"
SMALL = {"n": 64, "n_in": 16, "batch": 4}
SEED = 2**31 + 4242


def small_cfg(cell=CELL) -> dict:
    bench = R.load_benchmark()
    c = {w["name"]: w for w in bench["workloads"]}[cell]
    cfg = R.load_config(c["config"])
    cfg.update(SMALL)
    return cfg


def run_small(cell=CELL, seconds=0.2, trace=False, bench=None, cfg=None):
    bench = bench or R.load_benchmark()
    c = {w["name"]: w for w in bench["workloads"]}[cell]
    return R.run_cell(bench, c, seed=SEED, seconds=seconds, trace=trace,
                      device="cpu", t_start=time.perf_counter(),
                      cfg=cfg or small_cfg(cell))


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    """One intra-op thread, and a traced stretch of the fewest units."""
    monkeypatch.setattr(R, "TRACE_S", 0.0)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_sound_run_is_correct():
    out = run_small()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"tokens_per_s", "step_ms_p90",
                                   "peak_mem_gb", "setup_s"}
    assert list(out)[-1] == "checks"
    assert out["metrics"]["tokens_per_s"]["unit"] == "tokens/s"


def test_traced_run_reads_the_per_layer_metrics_it_can_on_a_cpu():
    out = run_small(trace=True)
    assert out["correct"], out["checks"]
    # no device here: the device readers find nothing and are left out
    assert set(out["metrics"]) == {"trainer.host_ms_per_window",
                                   "learner.carry_gb", "device.window_mfu"}
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_control_fails_at_the_cells_limits():
    """The reference in the program's place, in TF32: not correct."""
    cfg = small_cfg()
    system = S.build(cfg, generator.load_mix("dense-act"), SEED, "cpu")
    xs, ys = system.reference_inputs()
    ref = S.load_reference(cfg["reference"])
    cap = S.stand_in_capture(ref, system.params0, system.masks, xs, ys, cfg,
                             system.k, precision="tf32")
    nums, _ = S.judge(ref, cap, system.params0, system.masks, xs, ys, cfg,
                      k=system.k, delta=cfg["check"]["v_margin"])
    limits = cfg["check"]["limits"]
    assert any(nums[n] > limits[n] for n in limits), nums


def _unchanged_carry(monkeypatch):
    from repro_torch.core import sparse_rtrl as SP
    inner = SP.flat_compact_fused_step

    def step(cfg, w, layout, a_prev, vals, idx_prev, x_t, **kw):
        a_new, hp, _, _, count, overflow = inner(cfg, w, layout, a_prev, vals,
                                                 idx_prev, x_t, **kw)
        return a_new, hp, vals, idx_prev, count, overflow
    monkeypatch.setattr(SP, "flat_compact_fused_step", step)


def _unchanged_params(monkeypatch):
    from repro_torch import optim
    inner = optim.adamw

    def adamw(**kw):
        opt = inner(**kw)

        def update(grads, state, params, step):
            return params, opt.update(grads, state, params, step)[1]
        return optim.Optimizer(opt.init, update, opt.slot_steps)
    monkeypatch.setattr(optim, "adamw", adamw)


def _half_batch(monkeypatch):
    from repro_torch.core import learner as L
    inner = L._LearnerBase._inst_loss_and_grads

    def half(po, a, y, tt, batch=None):
        h = a.shape[0] // 2
        loss, logits, gout, cbar = inner(po, a[:h], y[:h], tt, batch)
        return loss, logits, gout, torch.cat([cbar, torch.zeros_like(cbar)])
    monkeypatch.setattr(L._LearnerBase, "_inst_loss_and_grads",
                        staticmethod(half))


def _flipped_spike(monkeypatch):
    from repro_torch.core import sparse_rtrl as SP
    inner = SP.cell_partials

    def partials(cfg, w, a_prev, x_t):
        a_new, hp, J, mbar = inner(cfg, w, a_prev, x_t)
        a_new = a_new.clone()
        a_new[0, 3] = 1.0 - a_new[0, 3]
        return a_new, hp, J, mbar
    monkeypatch.setattr(SP, "cell_partials", partials)


def _altered_k1(monkeypatch):
    from repro_torch.kernels import compact_fused as CF
    inner = CF.fused_update

    def fused(*args):
        out = inner(*args).clone()
        out[0, 0, :8] += 1.0
        return out
    monkeypatch.setattr(CF, "fused_update", fused)


@pytest.mark.parametrize("plant", [
    _unchanged_carry,      # the RTRL step returns its state unchanged
    _unchanged_params,     # the update returns the parameters unchanged
    _half_batch,           # half the batch left out, the mean over the rest
    _flipped_spike,        # an answer (a spike) altered where it is produced
    _altered_k1,           # K1's answer altered where it is produced
], ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(monkeypatch, plant):
    """The run's harness with the program broken underneath.  (One chip:
    the cell has no exchange between chips to leave out.)"""
    plant(monkeypatch)
    out = run_small()
    assert not out["correct"], out["checks"]


def test_a_new_mix_and_metric_are_files_and_entries(tmp_path, monkeypatch):
    """Add bench/traffic/<mix>.json, bench/metrics/<name>.py and their
    entries: no file that is there is edited."""
    bench_dir = tmp_path / "bench"
    shutil.copytree(ROOT / "bench" / "traffic", bench_dir / "traffic")
    shutil.copytree(ROOT / "bench" / "metrics", bench_dir / "metrics")
    shutil.copytree(ROOT / "bench" / "e2e", bench_dir / "e2e")
    shutil.copytree(ROOT / "bench" / "configs", bench_dir / "configs")
    mix = json.loads((bench_dir / "traffic" / "sparse-act.json").read_text())
    mix["inputs"]["sigma"] = 16.0
    (bench_dir / "traffic" / "sparser-act.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "trainer.windows_traced.py").write_text(
        "def read(ctx):\n    return float(ctx['units'])\n")
    bench = R.load_benchmark()
    name = "scaled-n1024-k1024.sparser-act"
    bench["workloads"].append({"name": name, "config": "scaled-n1024-k1024",
                               "traffic": "sparser-act", "chips": 1,
                               "why": "sigma 16"})
    bench["per_layer"].append({"name": "trainer.windows_traced",
                               "unit": "windows", "better": "higher",
                               "source": "program_counter",
                               "layer": "trainer", "moves": "tokens_per_s",
                               "workloads": [name]})
    monkeypatch.setattr(R, "BENCH", bench_dir)
    monkeypatch.setattr(generator, "TRAFFIC_DIR", bench_dir / "traffic")
    seen = []
    inner = generator.make_stream

    def spy(mix, **kw):
        seen.append(mix["inputs"]["sigma"])
        return inner(mix, **kw)
    monkeypatch.setattr(generator, "make_stream", spy)
    out = run_small(cell=name, trace=True, bench=bench, cfg=small_cfg(CELL))
    assert seen == [16.0]
    assert out["metrics"]["trainer.windows_traced"]["value"] >= 4
    assert out["correct"], out["checks"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    base = set(R.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.core.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert set(R.forbidden_modules()) - base == {"repro", "jaxlib"} - base


def test_a_run_loads_no_jax_module():
    """A fresh process drives a run at the small width on the CPU and
    lists what it loaded: nothing of jax, jaxlib, flax or the JAX package,
    and the reference nothing of the program."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from bench import run as R
from bench.systems import scaled_online as S
before = set(sys.modules)
S.load_reference("scaled_rnn_reference")
ref_loads = sorted(set(sys.modules) - before)
bench = R.load_benchmark()
cell = {{w["name"]: w for w in bench["workloads"]}}[{CELL!r}]
cfg = R.load_config(cell["config"]); cfg.update({SMALL!r})
out = R.run_cell(bench, cell, seed=1, seconds=0.1, trace=False, device="cpu",
                 t_start=time.perf_counter(), cfg=cfg)
print(json.dumps({{"bad": R.forbidden_modules(), "ref": ref_loads,
                  "correct": out["correct"]}}))
"""
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert got.returncode == 0, got.stderr[-2000:]
    res = json.loads(got.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and res["correct"]
    assert not [m for m in res["ref"] if m.split(".")[0] == "repro_torch"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_cell_on_a_card(card):
    """The real cell, one short run, as the driver starts it."""
    got = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELL, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=str(ROOT))
    assert got.returncode == 0, got.stderr[-2000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
