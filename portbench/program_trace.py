"""The program's own spans and counters of a traced run, for the per-layer
metrics that read them.

The program keeps, under a profiler session, a record of named spans of
its host work and of counters (`se_unet_airseg_tpu_torch.utils.profiling`:
`record()` gives (name, thread, start and end in Unix ns, enclosing span,
whether the span was also a `record_function` range) and the counters).
The traced slice is the run's only profiler session, so the record read
once the run is over is the slice's. The spans on the threads the
profiler listens to are also host ranges of the slice's trace; those on
the Prefetcher's thread are in the record alone, and are put on the
trace's clock through the spans that are in both (`trace_offset_us`).

Every function returns None where there is nothing to read: a program
that keeps no record, a slice without the spans, a run of the other kind.
"""

from __future__ import annotations

import statistics
from collections import defaultdict

from portbench.trace import _merge


def program_record():
    """The program's record of the latest profiler session, or None where
    the program keeps none."""
    try:
        from se_unet_airseg_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "record", None)
    return read() if read is not None else None


def _ms(span) -> float:
    return (span.end_ns - span.start_ns) / 1e6


def _total_ms(prog, name: str) -> float:
    return sum(_ms(s) for s in prog.spans if s.name == name)


def _count(prog, name: str) -> int:
    return sum(1 for s in prog.spans if s.name == name)


def per_volume_ms(rec, name: str):
    """Host ms a volume of the slice in the span `name`, over the slice's
    `runner.volume` spans."""
    prog = program_record()
    if rec.kind != "infer" or prog is None:
        return None
    n = _count(prog, "runner.volume")
    total = _total_ms(prog, name)
    return total / n if n and total > 0 else None


def per_step_ms(rec, name: str):
    """Host ms a step of the slice in the span `name`."""
    prog = program_record()
    if rec.kind != "train" or prog is None or not rec.slice_work.get("steps"):
        return None
    total = _total_ms(prog, name)
    return total / rec.slice_work["steps"] if total > 0 else None


def counter_per_step(rec, name: str):
    """The counter `name` of the slice over its steps."""
    prog = program_record()
    if rec.kind != "train" or prog is None or not rec.slice_work.get("steps"):
        return None
    n = prog.counts.get(name)
    return n / rec.slice_work["steps"] if n else None


def per_batch_ms(rec, name: str):
    """Producer ms a batch in the span `name`: over the `data.batch` spans
    the record holds whole, the time of the `name` spans inside each."""
    prog = program_record()
    if rec.kind != "train" or prog is None:
        return None
    top = [None] * len(prog.spans)  # the data.batch span each span runs inside
    for i, s in enumerate(prog.spans):
        if s.name == "data.batch":
            top[i] = i
        elif s.parent is not None:
            top[i] = top[s.parent]
    batches = {i for i, s in enumerate(prog.spans) if s.name == "data.batch"}
    if not batches:
        return None
    total = sum(_ms(s) for s, b in zip(prog.spans, top) if s.name == name and b in batches)
    return total / len(batches)


def trace_offset_us(prog, trace):
    """The trace's clock less the record's (µs): the median, over the
    spans that are also ranges of the trace, of the range's start less the
    span's, each name's spans and ranges paired in order where both hold
    as many."""
    ranges = defaultdict(list)
    for a, _, n, _ in trace.host:
        ranges[n].append(a)
    mine = defaultdict(list)
    for s in prog.spans:
        if s.mirrored:
            mine[s.name].append(s.start_ns / 1e3)
    diffs = [a - b for n, starts in mine.items() if len(ranges[n]) == len(starts)
             for a, b in zip(sorted(ranges[n]), sorted(starts))]
    return statistics.median(diffs) if diffs else None


def idle_share_in(rec, name: str):
    """The share (%) of the slice's device-idle time during which a span
    `name` of the record was open."""
    prog = program_record()
    if rec.trace is None or prog is None:
        return None
    tr = rec.trace
    off = trace_offset_us(prog, tr)
    if off is None:
        return None
    clipped = [(max(s.start_ns / 1e3 + off, tr.t0), min(s.end_ns / 1e3 + off, tr.t1))
               for s in prog.spans if s.name == name]
    inside = _merge((a, b) for a, b in clipped if b > a)
    edges = [tr.t0] + [x for iv in tr.busy for x in iv] + [tr.t1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    both = 0.0
    for a, b in idle:
        for c, d in inside:
            both += max(0.0, min(b, d) - max(a, c))
    return 100.0 * both / total


def device_ms_under(rec, prefix: str, kind: str):
    """Device ms a tile batch (inference) or a step (training) of the work
    launched inside host ranges whose name starts with `prefix`."""
    if rec.trace is None or rec.kind != kind:
        return None
    passes = (rec.slice_work["tiles_run"] / rec.batch if kind == "infer"
              else rec.slice_work["steps"])
    dev_s = rec.trace.launched_under_s(lambda n: n.startswith(prefix))
    return 1e3 * dev_s / passes if dev_s > 0 and passes else None
