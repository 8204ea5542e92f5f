"""The readers of the program's spans in the idle gaps, on hand-built
reduced traces: exact sums, 0.0 where no gap carries the name, nothing
without a trace, without device work or without any program span (a
program that opens none), and the per-window and per-step divisors.  CPU
only; imports no JAX."""
from __future__ import annotations

import pytest

from bench import run as R, trace

READERS = ("trainer.gather_idle_ms_per_window",
           "trainer.span_idle_ms_per_window",
           "engine.span_idle_ms_per_step", "device.unattributed_idle")


def reduced(gaps, window_s=0.1, ops=10):
    return {"window_s": window_s, "busy_s": window_s - sum(s for _, s in gaps),
            "device": [], "gaps": list(gaps), "ops": ops}


GAPS = [("trainer.gather", 0.004), ("window", 0.001),
        ("trainer.gather", 0.002), ("trainer.record", 0.0005),
        ("trainer.readback", 0.00025), ("engine.partials", 0.003),
        ("k1.launch", 0.001), ("engine.rows", 0.0005),
        ("aten::empty", 0.002), (trace.NO_HOST_OP, 0.0025),
        ("cudaMemcpyAsync", 0.001)]


def read(name, ctx):
    return R.reader("metrics", name)(ctx)


def test_each_reader_sums_its_gaps_exactly():
    ctx = {"trace": reduced(GAPS), "units": 2, "steps": 16}
    assert read("trainer.gather_idle_ms_per_window", ctx) == \
        pytest.approx((0.004 + 0.002) / 2 * 1e3)
    assert read("trainer.span_idle_ms_per_window", ctx) == pytest.approx(
        (0.004 + 0.001 + 0.002 + 0.0005 + 0.00025) / 2 * 1e3)
    assert read("engine.span_idle_ms_per_step", ctx) == \
        pytest.approx((0.003 + 0.001 + 0.0005) / 16 * 1e3)
    assert read("device.unattributed_idle", ctx) == \
        pytest.approx(100 * 0.0025 / 0.1)


def test_the_divisors_are_the_traced_windows_and_steps():
    base = {"trace": reduced(GAPS), "units": 2, "steps": 16}
    twice = {"trace": reduced(GAPS), "units": 4, "steps": 32}
    for name in READERS[:3]:
        assert read(name, twice) == pytest.approx(read(name, base) / 2)
    # the share is of the traced window, whatever its windows and steps
    assert read("device.unattributed_idle", twice) == \
        read("device.unattributed_idle", base)
    for name in READERS[:3]:
        assert read(name, {**base, "units": 0, "steps": 0}) is None


def test_no_gap_of_the_name_reads_zero():
    ctx = {"trace": reduced([("engine.rows", 0.001), ("aten::mul", 0.002)]),
           "units": 1, "steps": 8}
    assert read("trainer.gather_idle_ms_per_window", ctx) == 0.0
    assert read("trainer.span_idle_ms_per_window", ctx) == 0.0
    assert read("device.unattributed_idle", ctx) == 0.0
    ctx = {"trace": reduced([("window", 0.001)]), "units": 1, "steps": 8}
    assert read("engine.span_idle_ms_per_step", ctx) == 0.0


def test_nothing_without_a_trace_or_without_device_work():
    for name in READERS:
        assert read(name, {"units": 2, "steps": 16}) is None
        assert read(name, {"trace": reduced(GAPS, ops=0), "units": 2,
                           "steps": 16}) is None


def test_a_program_without_spans_gives_only_the_unattributed_share():
    """A trace in which no gap carries a program span's name (a program
    that opens none): the span readers find nothing to split."""
    ctx = {"trace": reduced([(trace.NO_HOST_OP, 0.005),
                             ("cudaMemcpyAsync", 0.001),
                             ("aten::sum", 0.001)]), "units": 2, "steps": 16}
    for name in READERS[:3]:
        assert read(name, ctx) is None
    assert read("device.unattributed_idle", ctx) == pytest.approx(5.0)
