"""`--metrics-dir` and `--trace` on the port's launchers, held against the
JAX launchers and against the port's own runs without telemetry.

Bars: a guarded run with an injected fault emits the JAX launcher's
sequence of event kinds, with the same update, step and guard fields (the
losses differ: the params come from different generators); a run with
telemetry is bitwise the run without it, and ends with its JSON summary;
the offline and serve paths write directories that both validators pass.
"""
import json
import sys

import pytest
import torch

from repro.obs import read_events as j_read_events
from repro.obs.validate import validate_dir as j_validate_dir
from repro_torch.launch import serve as SERVE, train as TRAIN
from repro_torch.obs import read_events
from repro_torch.obs.validate import validate_dir

_ARGV = ["--arch", "egru-spiral", "--online", "--sparsity", "0.8",
         "--ckpt-every", "0"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_GUARD_FIELDS = ("update", "step", "reason", "attempt", "to_step",
                 "to_update", "action", "attempts", "guard_action")


def _shape(events):
    """Each event's kind with its update, step and guard fields, and, for a
    window, the telemetry fields it carries."""
    out = []
    for e in events:
        rec = {k: e[k] for k in _GUARD_FIELDS if k in e}
        if e["kind"] == "window":
            rec["fields"] = sorted(k for k in e if k not in ("ts", "dt_ms"))
        out.append((e["kind"], rec))
    return out


def test_launcher_guard_events_equal_reference(tmp_path, monkeypatch):
    """`--guard --inject-corrupt-at 5 --metrics-dir` (10 updates of k = 8
    at full width, compact): the port's events are the JAX launcher's, in
    order — run_start, 5 windows, fault, rollback, the replayed window with
    its recovery, the rest, run_end — and both directories validate under
    both validators."""
    argv = [*_ARGV, "--rtrl-backend", "compact", "--steps", "10", "--guard",
            "--inject-corrupt-at", "5"]
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    out = TRAIN.main([*argv, "--device", "cpu", "--metrics-dir", str(ours)])
    from repro.launch import train as JTRAIN
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--ckpt-dir",
                                      str(tmp_path / "ck"), "--metrics-dir",
                                      str(theirs)])
    JTRAIN.main()
    for d in (ours, theirs):
        assert validate_dir(d) == [] and j_validate_dir(d) == []
    ev, jev = read_events(ours / "events.jsonl"), j_read_events(
        theirs / "events.jsonl")
    assert _shape(ev) == _shape(jev)
    kinds = [e["kind"] for e in ev]
    assert kinds.count("window") == 10
    assert [k for k in kinds if k not in ("window",)] == [
        "run_start", "fault", "rollback", "recovery", "run_end"]
    man = json.loads((ours / "manifest.json").read_text())
    jman = json.loads((theirs / "manifest.json").read_text())
    for key in ("guard_faults_total", "guard_rollbacks_total",
                "guard_recoveries_total", "windows_total", "updates",
                "final_step"):
        assert man["metrics"][key] == jman["metrics"][key], key
    assert man["metrics"]["guard_faults_total"] == out["guard"]["faults"] == 1
    for key in ("arch", "mode", "backend", "col_compact"):
        assert man["config"][key] == jman["config"][key], key


@pytest.mark.parametrize("extra", [
    ["--rtrl-backend", "compact_fused"],
    ["--rtrl-backend", "pallas", "--rewire", "rigl", "--rewire-every", "2"],
    ["--rtrl-backend", "compact_fused", "--layers", "2", "--guard"]])
def test_launcher_telemetry_run_is_bitwise_the_bare_run(extra, tmp_path,
                                                        capsys):
    """The same run with and without `--metrics-dir --trace`: the same
    window losses and metric records; a `window` event and span per
    update carrying the window's loss; the JSON summary the last line."""
    argv = [*_ARGV, "--device", "cpu", "--steps", "6", *extra]
    bare = TRAIN.main(argv)
    capsys.readouterr()
    d = tmp_path / "m"
    inst = TRAIN.main([*argv, "--metrics-dir", str(d), "--trace"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == inst["summary"]
    assert "== train egru-spiral (online RTRL) ==" in printed
    loss = lambda o: [w["loss"] for w in o["windows"]]
    assert loss(bare) == loss(inst)
    # the records' metric keys (a packed guarded window drops grad_norm,
    # as the reference's does) beside the events' keys; rewire_ms is wall
    # time
    keys = ("update", "step", "loss", "alpha", "beta", "overflow",
            "rewire_event", "rewire_frac", "carry_live_bytes",
            "guard_action")
    keep = lambda o: [{k: m[k] for k in keys if k in m}
                      for m in o["metrics"]]
    assert keep(bare) == keep(inst)
    assert validate_dir(d) == [] and j_validate_dir(d) == []
    wins = [e for e in read_events(d / "events.jsonl")
            if e["kind"] == "window"]
    assert [w["loss"] for w in wins] == loss(inst)
    spans = json.loads((d / "trace.json").read_text())["traceEvents"]
    assert [s["name"] for s in spans].count("window") == 6
    if "--rewire" in extra:
        rw = [e for e in read_events(d / "events.jsonl")
              if e["kind"] == "rewire"]
        assert len(rw) == inst["rewire_events"] == 3
        assert all(0.0 < w["live_col_frac"] <= 1.0 for w in wins)
        assert [s["name"] for s in spans].count("rewire") == 3


def test_launcher_offline_and_ckpt_events(tmp_path, capsys):
    d = tmp_path / "off"
    out = TRAIN.main(["--arch", "egru-spiral", "--rtrl-backend", "compact",
                      "--sparsity", "0.8", "--device", "cpu", "--steps", "2",
                      "--ckpt-every", "0", "--ckpt-dir", str(tmp_path / "c0"),
                      "--metrics-dir", str(d)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        out["summary"]
    assert validate_dir(d) == [] and j_validate_dir(d) == []
    man = json.loads((d / "manifest.json").read_text())
    assert (man["config"]["mode"], man["config"]["backend"]) == \
        ("offline", "compact")
    assert man["final"]["final_step"] == 2
    d2 = tmp_path / "on"
    TRAIN.main([*_ARGV[:-2], "--rtrl-backend", "compact", "--device", "cpu",
                "--steps", "4", "--update-every", "2", "--ckpt-every", "2",
                "--ckpt-dir", str(tmp_path / "c1"), "--metrics-dir", str(d2)])
    ck = [e for e in read_events(d2 / "events.jsonl")
          if e["kind"] == "ckpt_write"]
    assert [(e["step"], e["update"]) for e in ck] == [(4, 2), (8, 4),
                                                      (8, 4)]


def test_serve_decode_metrics_dir(tmp_path, capsys):
    d = tmp_path / "serve"
    out = SERVE.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                      "--metrics-dir", str(d), "--trace"])
    printed = capsys.readouterr().out
    assert "== serve rwkv6-3b (decode) ==" in printed
    assert out["summary"]["failed"] == 0
    assert validate_dir(d) == [] and j_validate_dir(d) == []
    man = json.loads((d / "manifest.json").read_text())
    assert man["config"]["mode"] == "decode"
    assert man["final"]["tokens"] == out["summary"]["tokens"] == 72
    assert man["metrics"]["tokens"] == 72
