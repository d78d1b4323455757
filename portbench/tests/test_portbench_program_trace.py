"""The metrics read from the program's own spans and counters, against a
synthetic record and trace whose numbers are worked out by hand, and their
silence where the program keeps no record."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import harness, program_trace
from portbench.trace import SLICE, Trace

OFF_US = 1e9  # the record's clock less the trace's, in microseconds
MAIN, AUTOGRAD, PRODUCER = 11, 12, 13


def _span(name, a_us, b_us, thread=MAIN, parent=None, mirrored=True):
    """A record span over [a_us, b_us] of the trace's clock."""
    return SimpleNamespace(name=name, thread=thread, thread_name="t", parent=parent,
                           start_ns=int((a_us + OFF_US) * 1e3),
                           end_ns=int((b_us + OFF_US) * 1e3), mirrored=mirrored)


def _x(name, cat, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _trace(host_spans) -> Trace:
    """A slice [1000, 11000] µs, the device busy over [1000, 3000] and
    [6000, 8000] (idle 6000 µs); a 500 µs kernel launched inside the first
    norm.stats range and a 300 µs one inside norm.bwd_stats on the
    autograd thread; the mirrored spans as host ranges."""
    ev = [_x(SLICE, "user_annotation", 1000, 10000),
          _x("k0", "kernel", 1000, 1500, correlation=1),
          _x("k1", "kernel", 2500, 500, correlation=7),
          _x("k2", "kernel", 6000, 1700, correlation=2),
          _x("k3", "kernel", 7700, 300, correlation=8),
          _x("cudaLaunchKernel", "cuda_runtime", 1300, 5, correlation=7),
          _x("cudaLaunchKernel", "cuda_runtime", 5100, 5, tid=AUTOGRAD, correlation=8),
          _x("cudaLaunchKernel", "cuda_runtime", 900, 5, correlation=1),
          _x("cudaLaunchKernel", "cuda_runtime", 5900, 5, correlation=2)]
    ev += [_x(s.name, "user_annotation", s.start_ns / 1e3 - OFF_US,
              (s.end_ns - s.start_ns) / 1e3, tid=s.thread) for s in host_spans if s.mirrored]
    return Trace(ev)


def _norm_spans():
    return [_span("norm.stats", 1200, 1400), _span("norm.stats", 4000, 4100),
            _span("norm.bwd_stats", 5000, 5200, thread=AUTOGRAD)]


def _disk_record():
    spans = [_span("data.read", 1000, 1400, PRODUCER, mirrored=False),  # its batch began earlier
             _span("data.wait", 2000, 5000),
             _span("data.batch", 1500, 9500, PRODUCER, mirrored=False)]
    b0 = len(spans) - 1
    spans += [_span("data.read", 3500, 5500, PRODUCER, b0, False),
              _span("data.augment", 5500, 6500, PRODUCER, b0, False),
              _span("data.finalize", 6500, 9000, PRODUCER, b0, False),
              _span("data.read", 7000, 7500, PRODUCER, b0, False),
              _span("data.wait", 8000, 10800),
              _span("data.batch", 9500, 10500, PRODUCER, mirrored=False)]
    b1 = len(spans) - 1
    spans += [_span("data.read", 9600, 10000, PRODUCER, b1, False),
              _span("data.finalize", 10000, 10400, PRODUCER, b1, False)]
    return SimpleNamespace(spans=spans, counts={})


def _rec(kind, spans, **slice_work):
    work = {"launches": {}, **slice_work}
    return harness.Record(kind=kind, setup_s=1.0, window_s=1.0, peak_bytes=0, work={},
                          crop=128, batch=8, trace=_trace(spans), slice_work=work)


@pytest.fixture
def program(monkeypatch):
    box = {}
    monkeypatch.setattr(program_trace, "program_record", lambda: box.get("rec"))
    return box


def _read(name, rec):
    return harness.metric_reader(name)(rec)


def test_data_metrics_by_hand(program):
    program["rec"] = _disk_record()
    rec = _rec("train", program["rec"].spans, steps=2)
    # two whole batches; the read of a batch begun before the slice is left out
    assert _read("data.read_ms", rec) == pytest.approx((2.0 + 0.5 + 0.4) / 2)
    assert _read("data.augment_ms", rec) == pytest.approx(1.0 / 2)
    assert _read("data.finalize_ms", rec) == pytest.approx((2.5 + 0.4) / 2)
    # idle [3000, 6000] and [8000, 11000]; reads over 3500-5500 and 9600-10000
    assert _read("data.idle_in_read_pct", rec) == pytest.approx(100 * 2400 / 6000)
    assert program_trace.trace_offset_us(program["rec"], rec.trace) == pytest.approx(-OFF_US)


def test_runner_and_norm_metrics_by_hand(program):
    spans = [_span("runner.volume", 1000, 6000), _span("runner.prep", 1000, 31000),
             _span("runner.decode", 40000, 140000), _span("runner.volume", 6000, 11000),
             _span("runner.prep", 50000, 100000), _span("runner.decode", 150000, 210000),
             *_norm_spans()]
    program["rec"] = SimpleNamespace(spans=spans, counts={})
    rec = _rec("infer", spans, tiles_run=16)
    for suffix in ("", ".convepi"):
        assert _read("runner.prep_ms" + suffix, rec) == pytest.approx((30 + 50) / 2)
        assert _read("runner.decode_ms" + suffix, rec) == pytest.approx((100 + 60) / 2)
    # two tile batches; k1 (0.5 ms) under norm.stats, k3 (0.3 ms) under norm.bwd_stats
    for name in ("norm_stats_ms.infer", "norm_stats_ms.convepi"):
        assert _read(name, rec) == pytest.approx((0.5 + 0.3) / 2)
    assert _read("norm_stats_ms.train", rec) is None


def test_step_metrics_by_hand(program):
    spans = [_span("train.upload", 1000, 41000), _span("train.upload", 50000, 94000),
             *_norm_spans()]
    program["rec"] = SimpleNamespace(spans=spans,
                                     counts={"train.h2d_bytes": 2 * 268_435_456})
    rec = _rec("train", spans, steps=2)
    assert _read("train.upload_ms", rec) == pytest.approx(42.0)
    assert _read("train.h2d_mb", rec) == pytest.approx(268.435456)
    assert _read("norm_stats_ms.train", rec) == pytest.approx(0.4)


NEW = ("data.read_ms", "data.augment_ms", "data.finalize_ms", "data.idle_in_read_pct",
       "runner.prep_ms", "runner.prep_ms.convepi", "runner.decode_ms",
       "runner.decode_ms.convepi", "norm_stats_ms.infer", "norm_stats_ms.convepi",
       "norm_stats_ms.train", "train.upload_ms", "train.h2d_mb")


@pytest.mark.parametrize("kind", ["infer", "train"])
def test_silent_without_the_programs_record(program, kind):
    # a program that keeps no record, and a trace without its ranges
    rec = _rec(kind, [], steps=2, tiles_run=16)
    assert all(_read(n, rec) is None for n in NEW)


def test_the_program_keeps_a_record():
    prog = program_trace.program_record()
    assert prog is not None and hasattr(prog, "spans") and hasattr(prog, "counts")
