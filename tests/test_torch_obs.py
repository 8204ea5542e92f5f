"""The port's telemetry plane (`repro_torch.obs`) held against the JAX
package's (`repro.obs`) and against its own bare paths.

Bars: the pure-Python layers (registry, events, summary, validator) give
the reference's text for the same calls, and a metrics directory of
either package validates under the other's validator; on the same numpy
params, masks and window the unpacked MetricPack fields agree with the
reference's within 1e-5 of each field's magnitude, with the same NaN
fields; inside the port the instrumented solo, guarded and stacked chunks
and the whole trainer run are bitwise the bare ones, and a window reads
back once; the guard's finite checks give the verdicts of the per-leaf
form on one poisoned element of any leaf and dtype, and copy no tree.
The JAX package's `pallas` backend runs its kernel in interpret mode.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as JOBS
from repro.core import cells as JC, learner as JL, sparse_rtrl as JSP
from repro.core import stacked_rtrl as JST
from repro.obs import validate as JVAL
from repro.optim import optimizers as JO
from repro.runtime import guard as JG, online as JON
from repro_torch import obs as OBS
from repro_torch.core import cells as C
from repro_torch.core.learner import LearnerSpec, make_learner
from repro_torch.obs import metricpack as MP, telemetry as TEL
from repro_torch.obs import trace as TR, validate as VAL
from repro_torch.optim import optimizers as O
from repro_torch.runtime import guard as G, online as ON
from repro_torch.tree import tree_leaves
from repro_torch.weights import masks_from_numpy, params_from_numpy

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small tensors: one intra-op thread a test process, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return jax.tree.map(np.asarray, t)


def _jt(t):
    return jax.tree.map(jnp.asarray, t)


# ---------------------------------------------------------------------------
# the pure-Python layers, against the reference
# ---------------------------------------------------------------------------

def _drive_registry(mod):
    """The same calls on a registry of `mod` (either package's obs)."""
    reg = mod.Registry()
    reg.counter("windows_total").inc()
    reg.counter("windows_total").inc(2.5)
    reg.counter("guard_faults_total", sid="u1").inc()
    reg.gauge("loss").set(0.123456789)
    reg.gauge("nan_gauge").set(float("nan"))
    reg.gauge("inf_gauge").set(-float("inf"))
    reg.gauge("big").set(3.0e38)
    reg.gauge("session_loss", sid="a").set(1.5)
    reg.gauge("session_loss", sid="b").set(np.float32(2.25))
    reg.histogram("empty_ms")
    h = reg.histogram("window_ms")
    for v in np.random.default_rng(5).lognormal(2.0, 1.2, size=400):
        h.observe(v)
    h.observe(1e6)                                  # the +Inf bucket
    h2 = reg.histogram("tiny", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 5.0, 50.0):
        h2.observe(v)
    return reg


def test_registry_text_snapshot_and_quantiles_equal_reference():
    ours, theirs = _drive_registry(OBS), _drive_registry(JOBS)
    assert ours.to_prometheus() == theirs.to_prometheus()
    assert repr(ours.snapshot()) == repr(theirs.snapshot())
    for name in ("window_ms", "tiny", "empty_ms"):
        a, b = ours.histogram(name), theirs.histogram(name)
        for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
            assert repr(a.quantile(q)) == repr(b.quantile(q)), (name, q)
    assert OBS.DEFAULT_LATENCY_BUCKETS_MS == JOBS.DEFAULT_LATENCY_BUCKETS_MS


def test_histogram_percentiles_vs_numpy():
    """Interpolated fixed-bucket quantiles land within one bucket width of
    numpy's exact sample percentiles — the estimator's error bound."""
    rng = np.random.default_rng(3)
    samples = rng.lognormal(mean=1.0, sigma=0.8, size=5000)
    edges = [0.1 * 1.3 ** i for i in range(40)]
    h = OBS.Histogram(edges)
    for s in samples:
        h.observe(s)
    full = [0.0] + list(edges) + [float(samples.max())]
    for q in (0.50, 0.95, 0.99):
        exact = float(np.percentile(samples, q * 100))
        est = h.quantile(q)
        i = int(np.searchsorted(edges, exact))
        width = full[i + 1] - full[i]
        assert abs(est - exact) <= width, (q, est, exact, width)
    assert h.count == 5000 and h.min == samples.min()
    i = int(np.searchsorted(edges, samples.max()))
    assert samples.max() <= h.quantile(1.0) <= full[i + 1] + 1e-9
    assert math.isnan(OBS.Histogram(edges).quantile(0.5))    # empty
    with pytest.raises(ValueError, match="strictly increasing"):
        OBS.Histogram([1.0, 1.0])
    with pytest.raises(ValueError, match="quantile"):
        h.quantile(1.5)


def test_registry_semantics_and_prometheus():
    reg = OBS.Registry()
    reg.counter("c").inc()
    reg.counter("c").inc(2)
    assert reg.counter("c").value == 3                   # get-or-create
    with pytest.raises(ValueError, match=">= 0"):
        reg.counter("c").inc(-1)
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("c")
    reg.gauge("g").set(1.5)
    reg.gauge("s", sid="u1").set(2.0)
    reg.gauge("s", sid="u2").set(3.0)
    h = reg.histogram("h", buckets=(1.0, 10.0))
    h.observe(0.5)
    h.observe(5.0)
    snap = reg.snapshot()
    assert snap["c"] == 3 and snap["g"] == 1.5
    assert snap['s{sid="u1"}'] == 2.0 and snap['s{sid="u2"}'] == 3.0
    assert snap["h"]["count"] == 2 and snap["h"]["sum"] == 5.5
    prom = reg.to_prometheus()
    assert "# TYPE c counter" in prom and "c 3" in prom
    assert '# TYPE h histogram' in prom
    assert 'h_bucket{le="1"} 1' in prom                  # cumulative
    assert 'h_bucket{le="10"} 2' in prom
    assert 'h_bucket{le="+Inf"} 2' in prom
    assert "h_count 2" in prom
    assert 's{sid="u1"} 2' in prom


_SUMMARIES = [
    ("t", {"loss": 0.123456789, "updates": 6, "skipme": 1,
           "guard": {"faults": 0}, "flag": None}, ("skipme",)),
    ("train egru-spiral (online RTRL)",
     {"arch": "egru-spiral", "final_step": 160, "updates": 20,
      "final_loss": 0.6931471805599453, "act_sparsity": float("nan"),
      "median_window_ms": 31.25, "restarts": 0, "ok": True,
      "big": 1e17, "items": [1.0, 2.5, None], "many": list(range(9)),
      "guard": {"faults": 1, "rollbacks": 1, "recovered": 1}}, ()),
    ("empty", {}, ()),
]


@pytest.mark.parametrize("case", range(len(_SUMMARIES)))
def test_format_summary_equals_reference(case):
    title, result, skip = _SUMMARIES[case]
    assert OBS.format_summary(title, result, skip=skip) == \
        JOBS.format_summary(title, result, skip=skip)


def test_format_summary_shape():
    txt = OBS.format_summary("t", {"loss": 0.123456789, "updates": 6,
                                   "skipme": 1, "guard": {"faults": 0},
                                   "flag": None}, skip=("skipme",))
    assert txt.startswith("== t ==")
    assert "skipme" not in txt
    assert "loss" in txt and "0.123457" in txt
    assert "updates" in txt and " 6" in txt
    assert "guard" in txt and "faults" in txt
    assert "flag" in txt and "-" in txt


def test_schema_and_catalogs_equal_reference():
    from repro.obs import telemetry as JTEL, trace as JTR
    assert OBS.KIND_FIELDS == JOBS.KIND_FIELDS
    assert OBS.SCHEMA_VERSION == JOBS.SCHEMA_VERSION
    assert VAL.MANIFEST_KEYS == JVAL.MANIFEST_KEYS
    assert TEL.WINDOW_GAUGES == JTEL.WINDOW_GAUGES
    assert TR.MAX_SPANS == JTR.MAX_SPANS
    assert [n for n, _ in OBS.DEFAULT_FIELDS] == \
        [n for n, _ in JOBS.DEFAULT_FIELDS]
    assert len(OBS.DEFAULT_FIELDS) == 11
    assert OBS.__all__ == JOBS.__all__


def test_event_log_round_trip_and_schema(tmp_path):
    log = OBS.EventLog(tmp_path / "e.jsonl")
    log.emit("run_start", run_id="r1")
    log.emit("window", update=1, step=3, dt_ms=2.5,
             loss=np.float32(1.25), overflow=float("nan"),
             grad_norm=torch.tensor(0.5))
    log.emit("rewire", event=1, frac=0.2, ms=3.0)
    log.close()
    evs = OBS.read_events(tmp_path / "e.jsonl")   # validates every record
    assert [e["kind"] for e in evs] == ["run_start", "window", "rewire"]
    assert all(e["v"] == OBS.SCHEMA_VERSION for e in evs)
    assert evs[1]["loss"] == 1.25                 # numpy scalar unwrapped
    assert evs[1]["grad_norm"] == 0.5             # so is a torch scalar
    assert evs[1]["overflow"] is None             # NaN -> null, strict JSON
    for line in (tmp_path / "e.jsonl").read_text().splitlines():
        json.loads(line, parse_constant=lambda c: pytest.fail(c))
    assert JOBS.read_events(tmp_path / "e.jsonl") == evs

    log2 = OBS.EventLog(tmp_path / "e2.jsonl")
    with pytest.raises(OBS.SchemaError, match="unknown event kind"):
        log2.emit("nope")
    with pytest.raises(OBS.SchemaError, match="missing fields"):
        log2.emit("window", update=1)             # step/dt_ms required
    log2.close()
    assert log2.written == 0
    (tmp_path / "bad.jsonl").write_text('{"v": 999, "kind": "window", '
                                        '"ts": 0}\n')
    with pytest.raises(OBS.SchemaError, match="schema version"):
        OBS.read_events(tmp_path / "bad.jsonl")
    for kind, fields in OBS.KIND_FIELDS.items():
        log3 = OBS.EventLog(tmp_path / "k.jsonl")
        log3.emit(kind, **{f: 1 for f in fields})
        log3.close()
    assert len(JOBS.read_events(tmp_path / "k.jsonl")) == len(OBS.KIND_FIELDS)


def test_tracer_nesting_and_chrome_export(tmp_path):
    tr = OBS.Tracer(enabled=True)
    with tr.span("window", update=0):
        with tr.span("rewire", frac=np.float32(0.2)):
            pass
        with tr.span("ckpt_write"):
            pass
    assert [s["name"] for s in tr.spans] == ["rewire", "ckpt_write",
                                             "window"]
    by = {s["name"]: s for s in tr.spans}
    assert by["window"]["depth"] == 0
    assert by["rewire"]["depth"] == 1 and by["ckpt_write"]["depth"] == 1
    for child in ("rewire", "ckpt_write"):
        assert by["window"]["ts"] <= by[child]["ts"]
        assert (by[child]["ts"] + by[child]["dur"]
                <= by["window"]["ts"] + by["window"]["dur"] + 1e-6)
    p = tr.export_chrome(tmp_path / "trace.json")
    doc = json.loads(p.read_text())
    assert doc["displayTimeUnit"] == "ms"
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert ev["window"]["ph"] == "X" and ev["rewire"]["args"] == {
        "frac": pytest.approx(0.2)}

    off = OBS.Tracer(enabled=False)
    with off.span("window"):
        pass
    assert off.spans == []


def test_tracer_spans_are_profiler_record_functions():
    """Recorded spans show under torch.profiler, holding the ops they
    issued (the counterpart of the reference's jax.profiler.TraceAnnotation
    passthrough)."""
    from torch.profiler import ProfilerActivity, profile
    tr = OBS.Tracer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("window", update=0):
            torch.ones(3).add_(1.0)
    evs = prof.events()
    win = [e for e in evs if e.name == "window"]
    assert len(win) == 1
    adds = [e for e in evs if e.name == "aten::add_"]
    assert adds and all(win[0].time_range.start <= e.time_range.start
                        and e.time_range.end <= win[0].time_range.end
                        for e in adds)
    assert [s["name"] for s in tr.spans] == ["window"]


def test_null_telemetry_is_inert_but_counts(tmp_path):
    obs = OBS.Telemetry.null()
    assert not obs.active
    assert obs.emit("window", update=0, step=0, dt_ms=1.0) is None
    with obs.span("window"):
        pass
    obs.record_window(1, 3, 2.0, packed={"loss": 0.5})
    assert obs.registry.counter("windows_total").value == 1
    assert obs.registry.gauge("loss").value == 0.5
    assert obs.finalize() is None
    assert list(tmp_path.iterdir()) == []        # wrote nothing anywhere


def _write_dir(mod, d):
    """A metrics directory written by `mod`'s Telemetry: every event kind,
    a window with a packed dict, spans, finalize."""
    obs = mod.Telemetry.create(d, trace=True, run_id="r0",
                               config={"arch": "egru-spiral", "n": 8})
    with obs.span("window", update=0, step=0):
        obs.record_window(1, 3, 2.5, packed={
            "loss": 0.5, "grad_norm": 0.25, "act_sparsity": 0.75,
            "bwd_sparsity": 0.125, "overflow": 0.0,
            "live_col_frac": float("nan"), "kb_min": 3.0, "kb_mean": 4.5,
            "kb_max": 6.0, "clip_factor": 1.0, "health": 0.0})
    for kind, fields in mod.KIND_FIELDS.items():
        if kind not in ("run_start", "run_end"):
            obs.emit(kind, **{f: 1 for f in fields})
    obs.finalize(final={"final_loss": 0.5, "bad": float("nan")})
    return obs


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_metrics_dirs_validate_under_both_validators(writer, tmp_path,
                                                     capsys):
    d = tmp_path / writer
    obs = _write_dir(OBS if writer == "port" else JOBS, d)
    assert sorted(p.name for p in d.iterdir()) == [
        "events.jsonl", "manifest.json", "metrics.prom", "trace.json"]
    assert VAL.validate_dir(d) == [] and JVAL.validate_dir(d) == []
    assert VAL.main([str(d)]) == 0 and JVAL.main([str(d)]) == 0
    assert OBS.read_events(d / "events.jsonl") == \
        JOBS.read_events(d / "events.jsonl")
    man = json.loads((d / "manifest.json").read_text())
    assert man["run_id"] == "r0" and man["config"]["n"] == 8
    assert man["final"] == {"final_loss": 0.5, "bad": None}
    assert man["metrics"]["loss"] == 0.5
    assert (d / "metrics.prom").read_text() == obs.registry.to_prometheus()
    # a broken directory fails both alike
    (d / "metrics.prom").write_text("")
    (d / "events.jsonl").write_text('{"v": 1, "kind": "window", "ts": 0}\n')
    assert VAL.validate_dir(d) == JVAL.validate_dir(d) != []
    assert VAL.main([str(d)]) == 1 and VAL.main([]) == 2


def test_telemetry_that_cannot_write_raises(tmp_path):
    """No fallback to the null form: a metrics directory that cannot be
    made raises."""
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.raises(OSError):
        OBS.Telemetry.create(blocker / "m")


# ---------------------------------------------------------------------------
# MetricPack: the fields against the reference's, and a pure observer
# ---------------------------------------------------------------------------

def _problem(engine="sparse", backend="compact", col=None, rewirable=False,
             n=8, k=3, B=4, seed=0):
    """The reference test's problem (n = 8, n_in = 3, k = 3): JAX-drawn
    params and masks as numpy, each package's learner, optimizer, carry
    and optimizer state on them, and one window."""
    if engine == "sparse":
        jcfg = JC.EGRUConfig(n_hidden=n, n_in=3, n_out=2, kind="gru")
        cfg = C.EGRUConfig(n_hidden=n, n_in=3, n_out=2, kind="gru")
        masks = JSP.make_masks(jcfg, jax.random.key(seed + 7), 0.5)
        params = JSP.apply_masks(JC.init_params(jcfg, jax.random.key(seed)),
                                 masks)
        params, masks = _np(params), _np(masks)
        pm = masks_from_numpy(masks, "cpu")
        opt_masks, jopt_masks = dict(pm), _jt(masks)
    else:
        jcfg = JC.StackedEGRUConfig(layer_sizes=(n, 6), n_in=3, n_out=2,
                                    kind="gru")
        cfg = C.StackedEGRUConfig(layer_sizes=(n, 6), n_in=3, n_out=2,
                                  kind="gru")
        masks = JST.make_stacked_masks(jcfg, jax.random.key(seed + 7), 0.5)
        params = JST.apply_stacked_masks(
            JC.init_stacked_params(jcfg, jax.random.key(seed)), masks)
        params, masks = _np(params), _np(masks)
        pm = [masks_from_numpy(m, "cpu") for m in masks]
        opt_masks = {"layers": pm, "out": None}
        jopt_masks = {"layers": _jt(masks), "out": None}
    rng = np.random.default_rng(seed + 1)
    xs = (rng.normal(size=(k, B, 3))
          * np.linspace(0.5, 2.5, B)[None, :, None]).astype(np.float32)
    ys = np.broadcast_to((np.arange(B) % 2).astype(np.int32), (k, B)).copy()

    jl = JL.make_learner(JL.LearnerSpec(
        engine=engine, cfg=jcfg, backend=backend, interpret=True,
        col_compact=col, rewirable=rewirable))
    jopt = JO.masked(JO.make_optimizer("adamw", lr=1e-2), jopt_masks)
    jp = _jt(params)
    jc = jl.init(jp, _jt(masks), (jnp.asarray(xs[0]), jnp.asarray(ys[0])),
                 t_total=float(k))
    ref = dict(learner=jl, opt=jopt, carry=jc, opt_state=jopt.init(jp),
               xs=jnp.asarray(xs), ys=jnp.asarray(ys))

    tl = make_learner(LearnerSpec(engine=engine, cfg=cfg, backend=backend,
                                  col_compact=col, rewirable=rewirable))
    opt = O.masked(O.make_optimizer("adamw", lr=1e-2), opt_masks)
    p = params_from_numpy(params, "cpu")
    tc = tl.init(p, pm, (torch.from_numpy(xs[0]), torch.from_numpy(ys[0])),
                 t_total=float(k))
    ours = dict(learner=tl, opt=opt, carry=tc, opt_state=opt.init(p),
                xs=torch.from_numpy(xs), ys=torch.from_numpy(ys), params=p,
                masks=pm)
    return ref, ours


# (engine, backend, col_compact, rewirable): every backend, col-compact on
# and off, a rewirable carry (live_col_frac) and the stacked carry (a
# per-layer idx tuple)
_PACK_CASES = [
    ("sparse", "compact", True, False),
    ("sparse", "compact", False, False),
    ("sparse", "compact_fused", True, False),
    ("sparse", "dense", None, False),
    ("sparse", "pallas", None, False),
    ("sparse", "pallas", False, False),
    ("sparse", "compact", True, True),
    ("sparse", "pallas", False, True),
    ("stacked", "compact_fused", None, False),
    ("stacked", "compact", None, True),
]


def _assert_packed_close(got: dict, want: dict):
    assert list(got) == list(want)
    nan_got = {k for k, v in got.items() if math.isnan(v)}
    nan_want = {k for k, v in want.items() if math.isnan(v)}
    assert nan_got == nan_want
    for k in got:
        if k in nan_got:
            continue
        scale = max(abs(want[k]), 1e-3)
        assert abs(got[k] - want[k]) <= REL * scale, (k, got[k], want[k])


@pytest.mark.parametrize("chunk", ["online", "guarded"])
@pytest.mark.parametrize("case", _PACK_CASES,
                         ids=["-".join(map(str, c)) for c in _PACK_CASES])
def test_packed_fields_equal_reference(case, chunk):
    engine, backend, col, rewirable = case
    ref, ours = _problem(engine, backend, col, rewirable)
    jpack, pack = JOBS.MetricPack.default(), OBS.MetricPack.default()
    if chunk == "online":
        _, _, jm = jax.jit(lambda c, o: JON.online_update_chunk(
            ref["learner"], ref["opt"], c, o, ref["xs"], ref["ys"],
            jnp.int32(0), pack=jpack))(ref["carry"], ref["opt_state"])
        _, _, m = ON.online_update_chunk(
            ours["learner"], ours["opt"], ours["carry"], ours["opt_state"],
            ours["xs"], ours["ys"], 0, pack=pack)
    else:
        _, _, jm = jax.jit(lambda c, o: JG.guarded_update_chunk(
            ref["learner"], ref["opt"], c, o, ref["xs"], ref["ys"],
            jnp.int32(0), jnp.float32(np.inf), pack=jpack))(
                ref["carry"], ref["opt_state"])
        _, _, m = G.guarded_update_chunk(
            ours["learner"], ours["opt"], ours["carry"], ours["opt_state"],
            ours["xs"], ours["ys"], 0, math.inf, pack=pack)
    assert set(m) == {"packed"}
    assert m["packed"].shape == (11,) and m["packed"].dtype == torch.float32
    got, want = pack.unpack(m["packed"]), jpack.unpack(jm["packed"])
    _assert_packed_close(got, want)
    assert math.isfinite(got["grad_norm"]) and got["grad_norm"] > 0
    assert math.isnan(got["live_col_frac"]) != rewirable
    compact = backend in ("compact", "compact_fused")
    assert math.isnan(got["kb_mean"]) != compact


def test_pack_nan_marks_inapplicable_fields():
    """Fields with no source in the env pack NaN — the same fields as the
    reference's — built on the loss's device."""
    pack = OBS.MetricPack.default()
    vec = pack.pack({"loss": torch.tensor(2.5)})
    assert vec.dtype == torch.float32 and vec.shape == (11,)
    pk = pack.unpack(vec)
    jpk = JOBS.MetricPack.default().unpack(JOBS.MetricPack.default().pack(
        {"loss": jnp.float32(2.5)}))
    _assert_packed_close(pk, jpk)
    assert pk["loss"] == 2.5
    assert pk["clip_factor"] == 1.0 and pk["health"] == 0.0  # defaults
    for name in ("grad_norm", "act_sparsity", "bwd_sparsity", "overflow",
                 "live_col_frac", "kb_min", "kb_mean", "kb_max"):
        assert math.isnan(pk[name]), name
    with pytest.raises(ValueError, match="fields"):
        pack.unpack(vec[:-1])
    with pytest.raises(ValueError, match="duplicate"):
        OBS.MetricPack((("a", None), ("a", None)))
    assert "loss" not in OBS.MetricPack.default(exclude=("loss",)).names
    rows = pack.unpack(torch.stack([vec, vec]))      # leading axes -> arrays
    assert rows["loss"].tolist() == [2.5, 2.5]


def test_pack_builds_every_field_on_the_loss_device(monkeypatch):
    """No field makes a tensor on another device or copies one from the
    host: every field's tensor is created on the loss's device (a meta
    loss here, so a stray CPU constant would fail the stack)."""
    ref, ours = _problem("sparse", "compact", True, True)
    monkeypatch.setattr(torch.Tensor, "item", lambda self: pytest.fail(
        "pack read a value back"))
    monkeypatch.setattr(torch.Tensor, "tolist", lambda self: pytest.fail(
        "pack read a value back"))
    env = {"loss": torch.zeros((), device="meta"),
           "stats": {"alpha": torch.zeros(3, device="meta")},
           "carry": {"idx": torch.zeros((4, 5), dtype=torch.int32,
                                        device="meta"),
                     "rw": {"colm": torch.ones(16, device="meta")}},
           "grads": {"w": torch.ones(3, device="meta")},
           "health": torch.zeros((), dtype=torch.int32, device="meta")}
    vec = OBS.MetricPack.default().pack(env)
    assert vec.device.type == "meta" and vec.shape == (11,)


def _tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            np.testing.assert_array_equal(x, y)


_BITWISE_CASES = [("sparse", "compact", True), ("sparse", "compact", False),
                  ("sparse", "compact_fused", True), ("sparse", "dense", None),
                  ("sparse", "pallas", None),
                  ("stacked", "compact_fused", None),
                  ("stacked", "pallas", None)]


@pytest.mark.parametrize("engine,backend,col", _BITWISE_CASES)
def test_packed_solo_chunk_bitwise_equals_bare(engine, backend, col):
    """online_update_chunk with a MetricPack returns carry / optimizer
    state BIT-IDENTICAL to the bare chunk, and only the vector."""
    _, t = _problem(engine, backend, col)
    pack = OBS.MetricPack.default()
    c_a, o_a, m_a = ON.online_update_chunk(
        t["learner"], t["opt"], t["carry"], t["opt_state"], t["xs"],
        t["ys"], 0)
    c_b, o_b, m_b = ON.online_update_chunk(
        t["learner"], t["opt"], t["carry"], t["opt_state"], t["xs"],
        t["ys"], 0, pack=pack)
    _tree_equal((c_a, o_a), (c_b, o_b))
    assert set(m_b) == {"packed"} and m_b["packed"].shape == (
        len(pack.names),)
    pk = pack.unpack(m_b["packed"])
    assert np.float32(pk["loss"]) == m_a["loss"].numpy()
    assert np.float32(pk["act_sparsity"]) == m_a["alpha"].numpy()
    assert np.float32(pk["bwd_sparsity"]) == m_a["beta"].numpy()


@pytest.mark.parametrize("engine,backend,col", _BITWISE_CASES)
def test_packed_guarded_chunk_bitwise_and_verdict_fields(engine, backend,
                                                         col):
    """Guard chunk + pack: the same bit-identity with the bare guarded and
    the unguarded chunk, and the vector carries the verdict (health 0,
    clip_factor exactly 1 at clip=+inf, grad_norm the clip norm)."""
    _, t = _problem(engine, backend, col)
    pack = OBS.MetricPack.default()
    args = (t["learner"], t["opt"], t["carry"], t["opt_state"], t["xs"],
            t["ys"], 0)
    c_u, o_u, _ = ON.online_update_chunk(*args)
    c_a, o_a, m_a = G.guarded_update_chunk(*args, math.inf)
    c_b, o_b, m_b = G.guarded_update_chunk(*args, math.inf, pack=pack)
    _tree_equal((c_a, o_a), (c_b, o_b))
    _tree_equal((c_u, o_u), (c_b, o_b))
    pk = pack.unpack(m_b["packed"])
    assert pk["health"] == 0.0 and pk["clip_factor"] == 1.0
    assert pk["grad_norm"] > 0.0 and math.isfinite(pk["grad_norm"])
    assert np.float32(pk["grad_norm"]) == m_a["grad_norm"].numpy()
    assert np.float32(pk["loss"]) == m_a["loss"].numpy()


# ---------------------------------------------------------------------------
# the trainer with telemetry
# ---------------------------------------------------------------------------

def _stream(B=4):
    xs_all = np.random.default_rng(0).normal(
        size=(40, 20, 3)).astype(np.float32)
    ys_all = np.random.default_rng(1).integers(0, 2, size=(40,))

    def stream(step):
        s, t = divmod(step, 20)
        sel = np.random.default_rng(100 + s).integers(0, 40, size=B)
        return xs_all[sel][:, t], ys_all[sel]

    return stream


def _trainer(telemetry=None, guard=None, plan=None, total=18, k=3,
             engine="sparse", backend="compact", tmp=None, ckpt_every=0):
    _, t = _problem(engine, backend)
    ocfg = ON.OnlineTrainerConfig(total_steps=total, update_every=k,
                                  ckpt_every=ckpt_every, log_every=1,
                                  ckpt_dir=str(tmp) if tmp else None)
    return ON.OnlineTrainer(ocfg, t["learner"], t["opt"], t["params"],
                            t["masks"], _stream(), device="cpu",
                            guard=guard, fault_plan=plan,
                            telemetry=telemetry)


def _strip(ms):
    return [{k: v for k, v in m.items() if k not in ("dt_s", "ms")}
            for m in ms]


@pytest.mark.parametrize("engine,backend,guarded", [
    ("sparse", "compact", False), ("sparse", "compact_fused", True),
    ("stacked", "compact_fused", False), ("stacked", "pallas", True)])
def test_trainer_with_telemetry_is_bitwise_identical(engine, backend,
                                                     guarded, tmp_path):
    """Instrumented run (active telemetry: the packed chunk, one readback a
    window) == bare run: the same metric records and windows, the same
    final carry and optimizer bits; the artifacts pass both validators."""
    guard = G.GuardConfig() if guarded else None
    bare = _trainer(guard=guard, engine=engine, backend=backend)
    out_a = bare.run()
    obs = OBS.Telemetry.create(tmp_path / "m", trace=True, run_id="t0",
                               config={"test": True})
    inst = _trainer(telemetry=obs, guard=guard, engine=engine,
                    backend=backend)
    assert inst._pack is not None and bare._pack is None
    out_b = inst.run()
    _tree_equal(bare.carry, inst.carry)
    _tree_equal(bare.opt_state, inst.opt_state)
    keep = ("loss", "alpha", "beta", "overflow", "update", "step")
    pick = lambda ms: [{k: v for k, v in m.items() if k in keep}
                       for m in ms]
    assert pick(out_a["metrics"]) == pick(out_b["metrics"])
    assert pick(out_a["windows"]) == pick(out_b["windows"])
    obs.finalize(final={"final_loss": out_b["metrics"][-1]["loss"]})
    assert VAL.validate_dir(tmp_path / "m") == []
    assert JVAL.validate_dir(tmp_path / "m") == []
    evs = OBS.read_events(tmp_path / "m" / "events.jsonl")
    kinds = [e["kind"] for e in evs]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    wins = [e for e in evs if e["kind"] == "window"]
    assert len(wins) == out_b["updates"] == 6
    compact = backend in ("compact", "compact_fused")
    for w, rec in zip(wins, out_b["windows"]):
        for f in ("loss", "grad_norm", "act_sparsity", "bwd_sparsity",
                  "clip_factor", "health", "dt_ms"):
            assert isinstance(w[f], (int, float)), f
        for f in ("kb_min", "kb_mean", "kb_max", "overflow"):
            assert (f in w) == compact, f
        assert w["loss"] == rec["loss"] and w["update"] == rec["update"]
    trace = json.loads((tmp_path / "m" / "trace.json").read_text())
    spans = [e for e in trace["traceEvents"] if e["name"] == "window"]
    assert len(spans) == out_b["updates"]
    man = json.loads((tmp_path / "m" / "manifest.json").read_text())
    assert man["run_id"] == "t0" and man["config"]["test"] is True
    assert man["metrics"]["loss"] == wins[-1]["loss"]
    assert man["metrics"]["updates"] == out_b["updates"]
    prom = (tmp_path / "m" / "metrics.prom").read_text()
    assert "# TYPE windows_total counter" in prom
    assert "window_ms_bucket" in prom


def test_guard_events_under_fault_plan(tmp_path):
    """A corrupted carry under the guard emits the contracted events —
    fault, rollback, recovery — and the guard report's counts come from
    the registry the events incremented; the run ends bitwise the clean
    one."""
    clean = _trainer(tmp=tmp_path / "c", total=30)
    clean.run()
    obs = OBS.Telemetry.create(tmp_path / "m", trace=True)
    t = _trainer(telemetry=obs, guard=G.GuardConfig(),
                 plan=G.FaultPlan(corrupt_carry_at_update=4), total=30,
                 tmp=tmp_path / "ck")
    out = t.run()
    obs.finalize()
    assert out["guard"]["faults"] == 1 and out["guard"]["rollbacks"] == 1
    assert t.guard.rollbacks == 1
    evs = OBS.read_events(tmp_path / "m" / "events.jsonl")
    by = {}
    for e in evs:
        by.setdefault(e["kind"], []).append(e)
    assert len(by["fault"]) == len(by["rollback"]) == len(by["recovery"]) == 1
    assert by["fault"][0]["reason"].startswith("nonfinite")
    assert by["rollback"][0]["to_step"] == by["recovery"][0]["step"] == 12
    assert by["recovery"][0]["action"] == "replay"
    reg = obs.registry
    assert reg.counter("guard_faults_total").value == 1
    assert reg.counter("guard_rollbacks_total").value == 1
    assert reg.counter("guard_recoveries_total").value == 1
    man = json.loads((tmp_path / "m" / "manifest.json").read_text())
    assert man["metrics"]["guard_faults_total"] == out["guard"]["faults"]
    spans = json.loads((tmp_path / "m" / "trace.json").read_text())
    assert [e["name"] for e in spans["traceEvents"]].count(
        "rollback_replay") == 1
    _tree_equal(clean.carry, t.carry)
    _tree_equal(clean.opt_state, t.opt_state)


def test_quarantine_and_ckpt_events(tmp_path):
    """NaN inputs walk the ladder to a quarantine (its event and counter),
    the skip_update rung keeps its own verdict, and each checkpoint write
    is an event and a span."""
    obs = OBS.Telemetry.create(tmp_path / "m", trace=True)
    t = _trainer(telemetry=obs, guard=G.GuardConfig(),
                 plan=G.FaultPlan(nan_input_at=9, nan_input_len=3),
                 total=30, tmp=tmp_path / "ck", ckpt_every=5)
    out = t.run()
    obs.finalize()
    kinds = [e["kind"] for e in OBS.read_events(
        tmp_path / "m" / "events.jsonl")]
    assert kinds.count("fault") == kinds.count("rollback") == 4
    assert kinds.count("quarantine") == 1 and kinds.count("recovery") == 1
    assert kinds.count("ckpt_write") == 3         # updates 5, 10 and final
    assert obs.registry.counter("guard_quarantined_total").value == 1
    assert obs.registry.counter("ckpt_writes_total").value == 3
    assert out["guard"]["quarantined"] == [{"start": 9, "len": 3,
                                            "update": 3}]
    wins = [e for e in OBS.read_events(tmp_path / "m" / "events.jsonl")
            if e["kind"] == "window"]
    assert len(wins) == 10
    assert [w.get("guard_action") for w in wins][3] == "quarantine"
    assert "loss" not in wins[3]
    assert all(math.isfinite(w["loss"]) for w in wins if "loss" in w)
    spans = json.loads((tmp_path / "m" / "trace.json").read_text())
    names = [e["name"] for e in spans["traceEvents"]]
    assert names.count("ckpt_write") == 3 and names.count("window") == 14


def test_stragglers_and_result_come_from_the_registry():
    obs = OBS.Telemetry.null()
    t = _trainer(telemetry=obs)
    t.cfg.straggler_factor = 0.0
    out = t.run()
    assert out["stragglers"] == t.stragglers == 5
    reg = obs.registry
    assert reg.counter("stragglers_total").value == 5
    assert out["updates"] == reg.gauge("updates").value == 6
    assert out["carry_bytes"] == reg.gauge("carry_alloc_bytes").value
    assert reg.counter("windows_total").value == 6


# ---------------------------------------------------------------------------
# one readback a window
# ---------------------------------------------------------------------------

_READBACKS = ("item", "tolist", "numpy", "cpu", "__float__", "__int__",
              "__bool__", "__index__")


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("backend", ["compact_fused", "dense"])
def test_window_reads_back_once(guarded, backend, tmp_path, monkeypatch):
    """With telemetry on, a window's only device->host readback is
    MetricPack.unpack — the guard reads the unpacked verdict.  (The
    compact kernels' index check reads back on CPU tensors only; it
    returns at once on the card, and is stubbed here as it runs there.)"""
    from repro_torch.kernels import compact as CK
    monkeypatch.setattr(CK, "check_idx", lambda idx, n: None)
    obs = OBS.Telemetry.create(tmp_path / "m")
    t = _trainer(telemetry=obs, guard=G.GuardConfig() if guarded else None,
                 backend=backend)
    state = {"in_window": False, "unpack": 0, "other": []}

    def counting(name, orig):
        def fn(self, *a, **kw):
            if state["in_window"] and not state.get("in_unpack"):
                state["other"].append(name)
            return orig(self, *a, **kw)
        return fn

    for name in _READBACKS:
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    unpack0 = OBS.MetricPack.unpack

    def unpack(self, vec):
        state["unpack"] += 1
        state["in_unpack"] = True
        try:
            return unpack0(self, vec)
        finally:
            state["in_unpack"] = False

    monkeypatch.setattr(OBS.MetricPack, "unpack", unpack)
    exec0 = ON.OnlineTrainer._execute_window

    def execute(self, start, k):
        state["in_window"] = True
        try:
            return exec0(self, start, k)
        finally:
            state["in_window"] = False

    monkeypatch.setattr(ON.OnlineTrainer, "_execute_window", execute)
    out = t.run()
    assert out["updates"] == 6
    assert state["unpack"] == 6 and state["other"] == []


# ---------------------------------------------------------------------------
# the guard's checks: no copy of the tree, the per-leaf verdicts
# ---------------------------------------------------------------------------

def _per_leaf_nonfinite(tree) -> bool:
    """The plain oracle: any floating leaf with a non-finite element."""
    return any(not bool(torch.isfinite(x).all()) for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor) and x.is_floating_point())


def _carry_nonfinite(tree) -> bool:
    """The guard's verdict on `tree` as a carry (the HEALTH_CARRY bit)."""
    bits = int(G.health_bits(torch.tensor(1.0), {}, tree))
    return bool(bits & G.HEALTH_CARRY)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"vals": torch.randn(4, 6, 10, generator=g),
            "M": (torch.randn(3, 5, generator=g).bfloat16(),
                  torch.randn(7, generator=g).half()),
            "a": torch.randn(2, 3, generator=g).double(),
            "idx": torch.full((4, 6), -1, dtype=torch.int32),
            "rw": {"live": torch.ones(9, dtype=torch.bool)},
            "loss": torch.tensor(0.5)}


_POISON = [(leaf, dtype, value, where)
           for leaf, dtype in (("vals", "float32"), ("M0", "bfloat16"),
                               ("M1", "float16"), ("a", "float64"),
                               ("loss", "float32"))
           for value in ("nan", "inf", "-inf")
           for where in ("first", "last")]


def _poisoned(leaf, value, where):
    tree = _tree()
    x = {"vals": tree["vals"], "M0": tree["M"][0], "M1": tree["M"][1],
         "a": tree["a"], "loss": tree["loss"]}[leaf]
    flat = x.view(-1)
    flat[0 if where == "first" else -1] = float(value)
    return tree


@pytest.mark.parametrize("leaf,dtype,value,where", _POISON)
def test_health_verdicts_bit_identical_on_one_poisoned_element(
        leaf, dtype, value, where):
    """One NaN or inf in one element of one leaf, of each dtype: the
    multi-tensor check gives the per-leaf verdict, and the reference's
    health bits where the reference holds the dtype (JAX runs without
    float64)."""
    tree = _poisoned(leaf, value, where)
    assert _carry_nonfinite(tree) is True
    assert _carry_nonfinite(_tree()) is False
    assert _per_leaf_nonfinite(tree) is True
    loss = torch.tensor(1.0)
    bits = int(G.health_bits(loss, {"g": torch.ones(2)}, tree))
    assert bits == G.HEALTH_CARRY
    assert int(G.health_bits(loss, tree, {})) == G.HEALTH_GRADS
    if dtype != "float64":
        jtree = jax.tree.map(lambda x: jnp.asarray(
            x.float().numpy()).astype(str(x.dtype).removeprefix("torch.")),
            {k: v for k, v in tree.items() if k not in ("a", "rw")})
        want = int(JG.health_bits(jnp.float32(1.0), {"g": jnp.ones(2)},
                                  jtree))
        ours = int(G.health_bits(loss, {"g": torch.ones(2)},
                                 {k: v for k, v in tree.items()
                                  if k not in ("a", "rw")}))
        assert ours == want == G.HEALTH_CARRY


def test_health_check_finite_extremes_and_empty_trees():
    big = {"x": torch.full((5,), 3.0e38), "y": torch.full((3,), -6.0e4,
                                                          dtype=torch.half),
           "z": torch.tensor([torch.finfo(torch.bfloat16).max],
                             dtype=torch.bfloat16)}
    assert _carry_nonfinite(big) is False
    assert int(G.health_bits(torch.tensor(1.0), big, big)) == 0
    assert int(G.health_bits(torch.tensor(float("nan")), (), {})) == \
        G.HEALTH_LOSS
    ints = {"idx": torch.full((3,), 2 ** 31 - 1, dtype=torch.int32)}
    assert _carry_nonfinite(ints) is False
    empty = {"e": torch.zeros(0), "b": torch.zeros(0, 3).bfloat16()}
    assert int(G.health_bits(torch.tensor(1.0), empty, empty)) == 0


@pytest.mark.parametrize("bad", range(8))
@pytest.mark.parametrize("many", ["grads", "carry"])
def test_health_bits_of_every_fault_subset_equal_reference(bad, many):
    """Each subset of (loss, grads, carry) poisoned, with one source of one
    leaf and the other of many (the check pads the sources to one length):
    the bitmask is the reference's."""
    rng = np.random.default_rng(bad)
    few = {"w": rng.normal(size=(3,)).astype(np.float32)}
    lots = {f"l{i}": rng.normal(size=(i + 1, 4)).astype(np.float32)
            for i in range(7)}
    grads, carry = (lots, few) if many == "grads" else (few, lots)
    loss = np.float32(np.nan if bad & 1 else 0.5)
    if bad & 2:
        next(reversed(grads.values())).flat[-1] = np.inf
    if bad & 4:
        next(reversed(carry.values())).flat[0] = np.nan
    want = int(JG.health_bits(jnp.asarray(loss),
                              jax.tree.map(jnp.asarray, grads),
                              jax.tree.map(jnp.asarray, carry)))
    got = int(G.health_bits(torch.tensor(loss),
                            {k: torch.from_numpy(v) for k, v in grads.items()},
                            {k: torch.from_numpy(v) for k, v in carry.items()}))
    assert got == want == bad


def test_global_norm_is_the_reference_formulation():
    tree = _tree()
    jtree = jax.tree.map(lambda x: jnp.asarray(x.float().numpy()),
                         {k: v for k, v in tree.items() if k != "rw"})
    got = float(MP.global_norm({k: v for k, v in tree.items() if k != "rw"}))
    want = float(JOBS.metricpack.global_norm(jtree))
    assert got == pytest.approx(want, rel=1e-6)
    ref = math.sqrt(sum(float((x.double() ** 2).sum()) for x in tree_leaves(
        {k: v for k, v in tree.items() if k != "rw"})))
    assert got == pytest.approx(ref, rel=1e-6)
    assert float(MP.global_norm({})) == 0.0
    assert G.global_norm is MP.global_norm


def _allocated_bytes(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    return sum(max(e.cpu_memory_usage, 0) for e in prof.events())


def test_health_check_and_norm_copy_no_tree():
    """The finite checks and the norm reduce the leaves where they lie:
    what they allocate is a few scalars, not a copy of the tree (the
    concatenating form allocated the whole tree again)."""
    g = torch.Generator().manual_seed(0)
    tree = {"M": torch.randn(64, 64, 64, generator=g),
            "vals": torch.randn(32, 64, 64, generator=g),
            "h": torch.randn(64, 64, generator=g).bfloat16()}
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(tree))
    assert nbytes > 1_000_000
    # the two-f32-leaf tree: no widening copy in the norm
    f32 = {k: v for k, v in tree.items() if v.dtype == torch.float32}
    for fn in (lambda: G.health_bits(torch.tensor(0.0), {}, tree),
               lambda: G.health_bits(torch.tensor(0.0), f32, tree),
               lambda: MP.global_norm(f32)):
        assert _allocated_bytes(fn) < nbytes // 100
    concat = lambda: torch.cat([x.reshape(-1) for x in f32.values()])
    assert _allocated_bytes(concat) >= nbytes // 2       # the probe sees it
