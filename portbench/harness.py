"""One run of one cell: find its configuration, traffic mix, checks and
metrics by the names in `BENCHMARK.json`, run the mix's driver, read the
metrics, judge the outputs, print the result.

Everything is found by name, so a new cell needs new files and entries
only:
  * a configuration: `BENCHMARK.json`'s `configs[].file`, a JSON of the
    model's settings (`model` names what the drivers build);
  * a traffic mix: `portbench/traffic/<traffic>.json`, whose `driver` names
    the general generator in `portbench/drivers/<driver>.py` that reads it;
  * a cell's limits: `portbench/checks/<workload>.json`, each number the
    driver compares and its limit;
  * a metric: `portbench/metrics/<name>.py`, whose `read(record)` returns the
    number or None where the run has nothing to read.

A driver's `run(ctx)` returns an `Outcome`: what it attempted and failed, a
`Record` of what it measured, and the numbers it compared with their limits.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any

START = time.perf_counter()  # near the process's start; log lines count from it
ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# top-level modules the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "se_unet_airseg_tpu")


@dataclasses.dataclass
class Record:
    """What a run measured. `work` holds the window's counts (voxels,
    volumes, tiles, crops, steps); `spans` host seconds by name, one entry
    per occurrence in the window; `trace` the profiled slice (`trace.Trace`)
    and `slice_work` its counts and kernel launches."""
    kind: str  # "infer" or "train"
    setup_s: float
    window_s: float
    peak_bytes: int
    work: dict
    crop: int
    batch: int
    spans: dict = dataclasses.field(default_factory=dict)
    trace: Any = None
    slice_work: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    record: Record
    checks: list


@dataclasses.dataclass
class Context:
    """What a driver gets: the run's arguments, the cell's settings, and
    `t0`, the host clock at the process's start (set-up counts from it)."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    mix: dict
    limits: dict
    t0: float
    device: str = "cuda"
    scratch: str | None = None  # where the driver may write files


def log(*parts) -> None:
    """A progress line on standard error, with the process's host clock."""
    print(f"[portbench {time.perf_counter() - START:.3f} s]", *parts, file=sys.stderr, flush=True)


def load_bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> tuple[dict, dict]:
    """(the workload's entry, its configuration's entry)."""
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    return w, next(c for c in bench["configs"] if c["name"] == w["config"])


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_reader(name: str):
    """`read` of portbench/metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def read_metrics(specs: list, rec: Record) -> dict:
    out = {}
    for m in specs:
        v = metric_reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=False).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def result_line(out: Outcome, metrics: dict, device: dict, trace: bool) -> dict:
    rec = out.record
    line = {"correct": all(c.ok for c in out.checks) and out.failed == 0,
            "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
            "device": device}
    if trace and rec.trace is not None:
        line["breakdown"] = {"device_ops": rec.trace.top_ops(10),
                             "idle_gaps": rec.trace.idle_gaps(10)}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line
