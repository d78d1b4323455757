"""Where the whole-volume runner's time goes on the GPU.

    python -m se_unet_airseg_tpu_torch.tools.profile_runner [--trace PATH]

Runs the main path of `chip_smoke.py` (full-width SE-UNet, random
weights from seed 0, bf16, 128^3 tiles, step 64, batch 8) on a random
int16 320x256x320 volume (the `bench.py` recipe): one warm-up volume,
then one volume under `torch.profiler`. Prints one JSON line with the
host seconds of the call, the summed device time of its kernels and
copies, the device's idle share over the call, the device time by
category, and the 25 kernels with the most device time. `--trace`
keeps the chrome trace at PATH.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..infer import SlidingWindowRunner
from ..models import get_model

# first match wins; cuDNN's convolution kernels are implicit GEMMs, so
# the convolution patterns come before the GEMM ones
_CATEGORIES = [
    ("epilogue kernels", ("epilogue_kernel",)),
    ("cuDNN layout transforms", ("tensortransform", "nhwctonchw", "nchwtonhwc")),
    ("convolution", ("fprop", "conv", "implicit")),
    ("matmul", ("gemm", "cutlass", "cublas", "nvjet")),
    ("reduction (norm statistics, max pool)", ("reduce",)),
    ("square (norm statistics)", ("pow_tensor_scalar",)),
    ("dtype / layout copies", ("direct_copy", "copy", "memcpy", "memset", "catarray",
                               "transpose", "permute")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=Path, help="keep the chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_runner: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cfg, model = get_model(seed=0, compute_dtype=torch.bfloat16)
    runner = SlidingWindowRunner(model, cfg, cube=128, step=64, batch=8)
    rng = np.random.default_rng(0)
    vol = (rng.random((320, 256, 320)) * 1400.0 + 24.0).astype(np.int16)
    kw = dict(h_thresh=0.5, l_thresh=0.35, hu_shift=-1024.0)
    runner.predict_trits(vol, **kw)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.predict_trits(vol, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        trace = args.trace or Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    by_cat: dict = defaultdict(float)
    by_name: dict = defaultdict(lambda: [0.0, 0])
    busy_us = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        dur = float(e.get("dur", 0.0))
        busy_us += dur
        by_cat[_category(e["name"])] += dur / 1e3
        by_name[e["name"]][0] += dur / 1e3
        by_name[e["name"]][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    print(json.dumps({"profile_runner": {
        "card": card, "tiles": 48, "batch": 8, "host_s": wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall_s),
        "device_ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:160], "ms": v[0], "count": v[1]} for n, v in top],
    }}), flush=True)
    return 0 if busy_us > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
