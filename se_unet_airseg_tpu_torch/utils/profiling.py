"""Tracing/profiling utilities.

The reference's only observability is wall-clock prints persisted to
`_time.txt` reports (reference tree_parsing.py:53-76,
preprocessing.py:151-155). `time_report` keeps that contract; `Timer`
adds named phase timers and `device_trace` a trace of the host and the
card through `torch.profiler` (a Chrome trace, viewable in
chrome://tracing or Perfetto).

Counterpart of the JAX package's `utils/profiling.py`: `Timer` and
`time_report` are copies; `device_trace` traces with `torch.profiler`
where the JAX package uses `jax.profiler`.

Spans and counters inside the program (`span`, `count`, `record`). The
program names its host work where it happens: the data layer's parts
(`data.*`), the runner's (`runner.*`), the step's upload
(`train.upload`, counter `train.h2d_bytes`, on a mesh too), the norm
statistics (`norm.stats`, `norm.bwd_stats`), the mesh step's collectives
(`mesh.loss_sum`, `mesh.grad_reduce`) and Swin UNETR's parts
(`swin.stage`, `swin.attn`, `unetr.block`, `unetr.up`; counters
`swin.tokens`, `swin.tokens_attended`). They cost nothing unless a
`torch.profiler` session is open in the process (`device_trace`, or the
caller's own `torch.profiler.profile`): with none, `span` returns a
shared no-op after one flag check and `count` returns. Under a session
each span is kept in an in-memory record of that session (name, OS
thread, start, end, enclosing span); on the threads the profiler
listens to (the one that started it and the autograd engine's) it is
also a `record_function` range, so it sits in the profiler's trace
beside the kernels it launched. A plain thread's spans (the
Prefetcher's) are in the record alone; `device_trace` writes them into
its trace.

Clock: spans are stamped with `time.time_ns()`, the Unix clock the
profiler's events are on: an exported event's `ts` plus the trace's
`baseTimeNanoseconds` / 1e3 is the same microsecond. `device_trace`
converts through `baseTimeNanoseconds`; a reader holding only the
events converts through the spans that are both recorded and mirrored
(`Span.mirrored`), whose ranges the trace holds.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _torch_profiler
from torch.profiler import ProfilerActivity, profile, record_function


class Timer:
    """Named phase timer: `with Timer() as t: ... t.lap("phase")`."""

    def __init__(self):
        self.laps: dict[str, float] = {}
        self._t0 = time.perf_counter()

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        return False

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self.laps[name] = self.laps.get(name, 0.0) + dt
        self._t0 = now
        return dt


def time_report(path: str, lines: dict[str, float | int]):
    """Write a reference-style `_time.txt` report: one
    '<label> %d seconds' (or raw int) line per entry."""
    with open(path, "w") as f:
        for label, value in lines.items():
            if "time" in label.lower():
                f.write("%s %d seconds\n" % (label, value))
            else:
                f.write("%s %d\n" % (label, value))


# ------------------------------------------------------ spans and counters


class Span(NamedTuple):
    """A finished span: `thread` the OS thread id (a trace event's `tid`),
    `start_ns`/`end_ns` on the Unix clock, `parent` the index in
    `Record.spans` of the span it ran inside (None at the top or when that
    span is not in the record), `mirrored` whether it was also a
    `record_function` range."""
    name: str
    thread: int
    thread_name: str
    start_ns: int
    end_ns: int
    parent: int | None
    mirrored: bool


class Record(NamedTuple):
    """The latest profiler session's finished spans, in start order, and
    its counters."""
    spans: list
    counts: dict


class _Session:
    __slots__ = ("spans", "counts")

    def __init__(self):
        self.spans, self.counts = [], {}


class _On:
    __slots__ = ("name", "thread", "thread_name", "start_ns", "end_ns", "parent", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_native_id()
        self.thread_name = threading.current_thread().name
        self.end_ns = None
        _current().spans.append(self)
        stack.append(self)
        self.range = None
        if torch.autograd._profiler_enabled():  # this thread's events reach the trace
            self.range = record_function(self.name)
            self.range.__enter__()
        # stamped next to the range's own ends, so that both read alike
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        _stack().pop()
        self.end_ns = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()  # the span of a process with no profiler session
_lock = threading.Lock()
_local = threading.local()
_session = _Session()
# set by a span, counter or `record()` outside any session, and by
# `device_trace`: the next span or counter under a session starts a new
# record
_stale = False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _current() -> _Session:
    global _session, _stale
    if _stale:
        with _lock:
            if _stale:
                _session, _stale = _Session(), False
    return _session


def span(name: str):
    """`with span("runner.prep"): ...` — a named span of host work. A
    shared no-op unless a profiler session is open (see the module)."""
    global _stale
    if not _torch_profiler._is_profiler_enabled:
        _stale = True
        return _OFF
    return _On(name)


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name` of the open profiler session; nothing
    without one."""
    global _stale
    if not _torch_profiler._is_profiler_enabled:
        _stale = True
        return
    session = _current()
    with _lock:
        session.counts[name] = session.counts.get(name, 0) + int(n)


def record() -> Record:
    """The spans and counters of the latest profiler session (a copy);
    spans still open are left out. A session's record starts with its
    first span or counter after a span, counter or `record()` call outside
    any session (or at `device_trace`'s start), so two sessions with none
    of these between them share one record."""
    global _stale
    if not _torch_profiler._is_profiler_enabled:
        _stale = True
    with _lock:
        spans, counts = list(_session.spans), dict(_session.counts)
    done = [s for s in spans if s.end_ns is not None]
    index = {id(s): i for i, s in enumerate(done)}
    return Record([Span(s.name, s.thread, s.thread_name, s.start_ns, s.end_ns,
                        index.get(id(s.parent)), s.range is not None) for s in done], counts)


def _add_spans(path: str, rec: Record) -> None:
    """Write the spans of `rec` that the profiler did not see (those of
    threads it does not listen to) into the Chrome trace at `path`, on its
    clock, each on its thread's row."""
    extra = [s for s in rec.spans if not s.mirrored]
    if not extra:
        return
    with open(path) as f:
        trace = json.load(f)
    base, pid = trace["baseTimeNanoseconds"], os.getpid()
    events = trace["traceEvents"]
    for tid, tname in sorted({(s.thread, s.thread_name) for s in extra}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": tname}})
    for s in extra:
        events.append({"ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid,
                       "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(log_dir: str = "./trace"):
    """torch.profiler over the block, CPU and (where there is a card)
    CUDA activities; on exit the Chrome trace is written to
    `<log_dir>/trace.json`, with the program's spans from threads the
    profiler does not listen to (the Prefetcher's `data.*`) added on its
    clock. Yields the profiler (`key_averages()` gives the sums by
    kernel); `record()` then holds the block's spans and counters."""
    global _stale
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _stale = True  # the block's spans start a new record
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, record())
