"""The program's spans (`repro_torch.obs.trace`) inside the scaled step and
the trainer's window: host ranges under a `torch.profiler` session, nested
as the phases run, no user annotation; a record of an enabled Tracer,
stamped on the profiler's clock; nothing at all with neither; and the
trainer's outputs bitwise the same with a profiler session and without.
CPU only, small widths; imports no JAX."""
from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs as OBS
from repro_torch.core import scaled_rtrl as SR
from repro_torch.core.learner import LearnerSpec, make_learner
from repro_torch.obs import trace as TR
from repro_torch.optim import optimizers as O
from repro_torch.runtime import guard as G, online as ON
from repro_torch.tree import tree_leaves

K = 4                       # stream steps a window
STEP_SPANS = ("engine.partials", "engine.rows", "engine.mbar_rows",
              "k1.launch", "engine.readout", "engine.grads")
WINDOW_SPANS = ("trainer.gather", "engine.read_window", "engine.update",
                "trainer.readback")
ALL_SPANS = ("window", "trainer.record") + STEP_SPANS + WINDOW_SPANS


def _trainer(telemetry=None, guard=None, windows=3):
    cfg = SR.ScaledRTRLConfig(n=32, n_in=8, n_out=3, batch=3,
                              beta_capacity=0.5, sparsity=0.75)
    tp, tm = SR.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    learner = make_learner(LearnerSpec(engine="scaled", cfg=cfg,
                                       backend="compact_fused"))
    rng = np.random.default_rng(7)
    T = 8 * K
    xs = rng.standard_normal((T, cfg.batch, cfg.n_in)).astype(np.float32)
    ys = (np.arange(T * cfg.batch).reshape(T, cfg.batch)
          % cfg.n_out).astype(np.int32)
    opt = O.masked(O.adamw(lr=1e-3), {**tm, "out": None})
    return ON.OnlineTrainer(
        ON.OnlineTrainerConfig(total_steps=windows * K, update_every=K),
        learner, opt, tp, tm, lambda t: (xs[t], ys[t]), device="cpu",
        telemetry=telemetry, guard=guard)


def _profiled(tr):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = tr.run()
    return out, prof


def _spans(prof):
    return [e for e in prof.events() if e.name in ALL_SPANS]


def _inside(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("guarded", [False, True])
def test_a_window_shows_every_span_nested_as_the_phases_run(guarded):
    tr = _trainer(guard=G.GuardConfig() if guarded else None, windows=1)
    _, prof = _profiled(tr)
    spans = _spans(prof)
    names = [e.name for e in spans]
    want = {n: K for n in STEP_SPANS}
    want.update({n: 1 for n in ("window", "trainer.record") + WINDOW_SPANS})
    assert {n: names.count(n) for n in ALL_SPANS} == want
    assert not any(e.is_user_annotation for e in spans)
    (win,) = [e for e in spans if e.name == "window"]
    (rec,) = [e for e in spans if e.name == "trainer.record"]
    assert all(_inside(e, win) for e in spans
               if e.name not in ("window", "trainer.record"))
    assert rec.time_range.start >= win.time_range.end
    # K1's launch sits inside no other step phase, and holds the ops it ran
    k1 = [e for e in spans if e.name == "k1.launch"]
    steps = [e for e in spans if e.name in STEP_SPANS and e.name != "k1.launch"]
    assert not any(_inside(k, s) for k in k1 for s in steps)
    bmm = [e for e in prof.events() if e.name == "aten::bmm"]
    assert bmm and all(any(_inside(b, k) for k in k1) for b in bmm)
    # the step phases run in their order, once a step
    order = [e.name for e in sorted(spans, key=lambda e: e.time_range.start)
             if e.name in STEP_SPANS]
    assert order == list(STEP_SPANS) * K


def test_outputs_are_bitwise_with_and_without_a_profiler():
    bare = _trainer()
    out_a = bare.run()
    seen = _trainer()
    out_b, prof = _profiled(seen)
    assert sum(e.name == "window" for e in _spans(prof)) == 3
    for a, b in zip(tree_leaves(bare.carry), tree_leaves(seen.carry)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(bare.opt_state), tree_leaves(seen.opt_state)):
        assert torch.equal(a, b)
    assert [w["loss"] for w in out_a["windows"]] == \
        [w["loss"] for w in out_b["windows"]]


def test_without_tracer_or_profiler_nothing_is_recorded():
    assert TR.span("engine.rows") is TR._NULL
    obs = OBS.Telemetry.null()
    assert obs.span("window") is TR._NULL
    tr = _trainer(telemetry=obs, windows=1)
    tr.run()
    assert obs.tracer.spans == [] and obs.tracer.dropped == 0
    # an enabled Tracer records the module's spans only inside its own
    on = OBS.Tracer(enabled=True)
    with TR.span("engine.rows"):
        pass
    with on.span("window"):
        with TR.span("engine.rows"):
            pass
    assert [(s["name"], s["depth"]) for s in on.spans] == [
        ("engine.rows", 1), ("window", 0)]


def test_a_thread_does_not_record_into_anothers_tracer():
    on = OBS.Tracer(enabled=True)
    done = threading.Event()

    def other():
        with TR.span("engine.rows"):
            pass
        done.set()

    with on.span("window"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert done.is_set() and not t.is_alive()
    assert [s["name"] for s in on.spans] == ["window"]


def test_tracer_export_is_on_the_profilers_clock(tmp_path):
    obs = OBS.Telemetry.create(tmp_path / "m", trace=True, run_id="s0")
    tr = _trainer(telemetry=obs, windows=2)
    _, prof = _profiled(tr)
    obs.finalize()
    doc = json.loads((tmp_path / "m" / "trace.json").read_text())
    mine = [e for e in doc["traceEvents"] if e["name"] in ALL_SPANS]
    theirs = sorted(_spans(prof), key=lambda e: e.time_range.start)
    assert sorted(e["name"] for e in mine) == sorted(e.name for e in theirs)
    base_us = prof.profiler.kineto_results.trace_start_ns() / 1e3
    for e in mine:
        assert isinstance(e["ts"], int) and isinstance(e["dur"], int)
    starts = {}
    for e in theirs:
        starts.setdefault(e.name, []).append(e.time_range.start + base_us)
    for e in sorted(mine, key=lambda e: e["ts"]):
        assert abs(e["ts"] - starts[e["name"]].pop(0)) < 100.0
    # every phase of a window nests inside its `window` span
    wins = [e for e in mine if e["name"] == "window"]
    assert len(wins) == 2
    for e in mine:
        if e["name"] in STEP_SPANS + WINDOW_SPANS:
            assert any(w["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= w["ts"] + w["dur"]
                       for w in wins)
