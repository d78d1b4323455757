"""Reading a `torch.profiler` trace of a slice of a run: the device's busy
time, device time by kernel name or by the host range that launched it,
the longest idle gaps by what the host was doing, and the time under the
autograd engine's ranges.

A slice is the part of a run inside one `record_function(SLICE)` range;
every device interval (kernel, copy, memset) is clipped to it. Busy time is
the union of those intervals, so two overlapping kernels count once. A
kernel is attributed to a host range through its launch: the runtime or
driver call with the same correlation id, on the launching thread, inside
the range. The category table and the attribution to autograd nodes follow
the program's `tools/profile_runner.py`, copied here so that the yardstick
does not move with the program.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

SLICE = "portbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
BACKWARD = "autograd::engine::evaluate_function: "
# the program's hand-written conv kernels (K8-K11) and fused epilogues (K1/K2/K5)
CONV_KERNELS = ("phased_conv_stats_wgmma", "phased_conv_ungathered_wgmma",
                "dil2_dense_conv_stats_wgmma", "dil2_conv_stats_wgmma", "conv_stats_kernel")
EPILOGUE_KERNELS = ("epilogue_kernel", "persistent_ldg_kernel", "persistent_tma_kernel")
SHORT_GAP_US = 50.0  # gaps shorter than this are summed without a host label


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The events of one profiled slice (chrome trace format, microseconds)."""

    def __init__(self, events: list):
        spans = [e for e in events if e.get("ph") == "X"]
        win = [e for e in spans if e.get("cat") == "user_annotation" and e["name"] == SLICE]
        if not win:
            raise ValueError(f"the trace holds no {SLICE!r} range")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.device = []  # (start, end, name, correlation)
        for e in spans:
            if e.get("cat") in DEVICE_CATS:
                a = max(float(e["ts"]), self.t0)
                b = min(float(e["ts"]) + float(e.get("dur", 0.0)), self.t1)
                if b > a:
                    self.device.append((a, b, e["name"], e.get("args", {}).get("correlation")))
        self.launch = {e["args"]["correlation"]: (float(e["ts"]), e.get("tid"))
                       for e in spans if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "correlation" in e.get("args", {})}
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"],
                      e.get("tid")) for e in spans if e.get("cat") in HOST_CATS]
        self.busy = _merge((a, b) for a, b, _, _ in self.device)

    @classmethod
    def from_profiler(cls, prof, directory: str | None = None) -> "Trace":
        """Export `prof`'s chrome trace to a temporary file, read it, delete it."""
        fd, path = tempfile.mkstemp(suffix=".json", dir=directory)
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernel_s(self, names) -> float:
        """Device seconds of kernels whose name holds one of `names`."""
        return sum(b - a for a, b, n, _ in self.device if any(k in n for k in names)) / 1e6

    def _ranges(self, match) -> dict:
        """Merged host ranges whose name `match`es, by thread."""
        by_tid = defaultdict(list)
        for a, b, n, tid in self.host:
            if match(n):
                by_tid[tid].append((a, b))
        return {tid: _merge(iv) for tid, iv in by_tid.items()}

    def launched_under_s(self, match) -> float:
        """Device seconds of the operations launched inside a host range
        whose name `match`es."""
        ranges = self._ranges(match)
        starts = {tid: [r[0] for r in iv] for tid, iv in ranges.items()}
        total = 0.0
        for a, b, _, corr in self.device:
            ts, tid = self.launch.get(corr, (None, None))
            if ts is None or tid not in ranges:
                continue
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and ts <= ranges[tid][i][1]:
                total += b - a
        return total / 1e6

    def backward_s(self) -> float:
        """Device seconds launched under the autograd engine's node ranges."""
        return self.launched_under_s(lambda n: n.startswith(BACKWARD))

    def conv_s(self) -> float:
        """Device seconds of the convs: whatever an aten convolution op (or
        its backward) launched, and the hand-written conv kernels."""
        return (self.launched_under_s(lambda n: n.startswith("aten::") and "convolution" in n)
                + self.kernel_s(CONV_KERNELS))

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(float)
        for a, b, n, _ in self.device:
            by[n] += (b - a) / 1e6
        return [[n[:200], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle time in the slice by the innermost host range
        that holds each gap's midpoint (summed by name), largest first; gaps
        under SHORT_GAP_US summed under one name."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        by = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            if b - a < SHORT_GAP_US:
                by[f"gaps under {SHORT_GAP_US:g} us"] += (b - a) / 1e6
                continue
            mid = (a + b) / 2
            inner = [(e - s, n) for s, e, n, _ in self.host if s <= mid <= e and n != SLICE]
            label = min(inner)[1] if inner else "host outside any profiled op"
            by[label] += (b - a) / 1e6
        return [[n[:200], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
