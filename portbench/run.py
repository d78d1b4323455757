"""The benchmark of the PyTorch/CUDA SE-UNet on one or more NVIDIA GPUs.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs the cell `<name>` of `BENCHMARK.json` from the root of a checkout:
set-up (weights and inputs from the seed, warm-up), a window of `--seconds`,
with `--trace 1` a profiled slice after it, then the comparison of the
window's outputs with the plain reference. The last line of standard output
is one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
`breakdown` (traced runs) and `checks` (each number compared, with its
limit), which is also printed as the last lines of standard error. Exits 2
without a result when the cell's GPUs are missing, 3 when a JAX module was
loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.load_bench()
    work, conf = harness.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"portbench: {args.workload} needs {work['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    mix = harness.read_json(harness.BENCH / "traffic" / f"{work['traffic']}.json")
    ctx = harness.Context(
        workload=args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        config=harness.read_json(harness.ROOT / conf["file"]), mix=mix,
        limits=harness.read_json(harness.BENCH / "checks" / f"{args.workload}.json"),
        t0=T0, scratch=tempfile.gettempdir())
    torch.cuda.reset_peak_memory_stats()
    # the program prints progress on standard output; the result line is last
    with contextlib.redirect_stdout(sys.stderr):
        out = harness.driver(mix["driver"]).run(ctx)
    rec = out.record
    metrics = harness.read_metrics(harness.metrics_of(bench, args.workload, ctx.trace), rec)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": work["chips"], "memory_peak_bytes": rec.peak_bytes,
              "card": harness.card_power_limit()}
    if ctx.trace and rec.trace is not None:
        device.update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    line = harness.result_line(out, metrics, device, ctx.trace)
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
