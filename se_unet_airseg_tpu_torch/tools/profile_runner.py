"""Where the whole-volume runner's, or the train step's, time goes on the
GPU.

    python -m se_unet_airseg_tpu_torch.tools.profile_runner [--train] [--conv-stats | --conv-epi] [--trace PATH]

Default: runs the main path of `chip_smoke.py` (full-width SE-UNet,
random weights from seed 0, bf16, 128^3 tiles, step 64, batch 8) on a
random int16 320x256x320 volume (the `bench.py` recipe): one warm-up
volume, then one volume under `torch.profiler`. `--conv-stats`: the same
under `SEUNetConfig(conv_stats=True)`; `--conv-epi`: under
`SEUNetConfig(conv_epi=True)`.

`--train`: the stage-1 train step (`make_train_step`, full width, bf16,
AdamW, remat off) on a random batch of 8 crops of 128^3 (the `bench.py`
train recipe: uniform image, label > 0.7): two warm-up steps, then one
step under `torch.profiler`; with `--conv-stats` or `--conv-epi`, the
step under that configuration.

Prints one JSON line with the host seconds of the call, the summed
device time of its kernels and copies, the device's idle share over the
call, the device time by category, and the 25 kernels with the most
device time. With `--train` it also splits the device time by the
autograd node that launched it (the outermost
`autograd::engine::evaluate_function` range around the launch; "not in
backward" is the forward, the loss and the optimizer). `--trace` keeps
the chrome trace at PATH.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
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
from ..models import SEUNet, SEUNetConfig, get_model
from ..train import create_train_state, make_optimizer, make_train_step

# first match wins; cuDNN's convolution kernels are implicit GEMMs, so
# the convolution patterns come before the GEMM ones
_CATEGORIES = [
    ("epilogue kernels (forward, phased_normalize)", ("epilogue_kernel",)),
    ("wgmma K8 (phased conv stats, bf16)", ("phased_conv_stats_wgmma",)),
    ("wgmma K10 (dense dil-2 conv stats, bf16)", ("dil2_dense_conv_stats_wgmma",)),
    ("wgmma K11 (ungathered phased conv, bf16)", ("phased_conv_ungathered_wgmma",)),
    ("wgmma K9 (halo-brick dil-2 conv stats, bf16)", ("dil2_conv_stats_wgmma",)),
    ("conv kernel (K8-K11 in f32)", ("conv_stats_kernel",)),
    ("pool backward kernel", ("pool_bwd_kernel",)),
    ("cuDNN layout transforms", ("tensortransform", "nhwctonchw", "nchwtonhwc")),
    ("convolution", ("fprop", "dgrad", "wgrad", "conv", "implicit")),
    ("matmul", ("gemm", "cutlass", "cublas", "nvjet")),
    ("optimizer (AdamW)", ("multi_tensor", "adam")),
    ("reduction (norm statistics, max pool, backward sums)", ("reduce",)),
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


_BWD = "autograd::engine::evaluate_function: "


def _by_backward_node(events) -> dict:
    """Device ms by the outermost autograd node whose host range holds
    the kernel's launch (matched through the launch's correlation id)."""
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][len(_BWD):])
                    for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                    and e.get("name", "").startswith(_BWD)), key=lambda s: (s[0], -s[1]))
    outer, end = [], -1.0
    for sp in spans:  # keep the outermost ranges only
        if sp[0] >= end:
            outer.append(sp)
            end = sp[1]
    starts = [sp[0] for sp in outer]
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    out: dict = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts = launched_at.get(e.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
        node = outer[i][2] if i >= 0 and ts <= outer[i][1] else "not in backward"
        out[node] += float(e.get("dur", 0.0)) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _runner_call(conv_stats: bool, conv_epi: bool):
    """The whole-volume runner, warmed up: (call, description)."""
    cfg, model = get_model(seed=0, compute_dtype=torch.bfloat16)
    cfg = dataclasses.replace(cfg, conv_stats=conv_stats, conv_epi=conv_epi)
    runner = SlidingWindowRunner(model, cfg, cube=128, step=64, batch=8)
    rng = np.random.default_rng(0)
    vol = (rng.random((320, 256, 320)) * 1400.0 + 24.0).astype(np.int16)
    kw = dict(h_thresh=0.5, l_thresh=0.35, hu_shift=-1024.0)
    runner.predict_trits(vol, **kw)
    return (lambda: runner.predict_trits(vol, **kw)), {"tiles": 48, "batch": 8,
                                                        "conv_stats": conv_stats,
                                                        "conv_epi": conv_epi}


def _train_call(conv_stats: bool, conv_epi: bool):
    """The stage-1 train step at 128^3, batch 8, warmed up by two steps:
    (call, description)."""
    cfg = SEUNetConfig(compute_dtype=torch.bfloat16, conv_stats=conv_stats, conv_epi=conv_epi)
    tree = SEUNet(cfg, generator=torch.Generator().manual_seed(0)).cuda().params_tree()
    opt, _ = make_optimizer()
    holder = {"state": create_train_state(tree, opt)}
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"image": torch.rand((8, 128, 128, 128, 2), generator=gen, device="cuda"),
             "label": (torch.rand((8, 128, 128, 128), generator=gen, device="cuda")
                       > 0.7).float()}
    step = make_train_step(cfg, stage=1)

    def call():
        holder["state"], aux = step(holder["state"], batch, gen)
        return float(aux["loss"])

    call()
    call()
    return call, {"train_step": 1, "crop": 128, "batch": 8, "remat": cfg.remat,
                  "conv_stats": conv_stats, "conv_epi": conv_epi}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true",
                    help="profile one stage-1 train step instead of one volume")
    ap.add_argument("--conv-stats", action="store_true",
                    help="profile the runner (or step) under SEUNetConfig(conv_stats=True)")
    ap.add_argument("--conv-epi", action="store_true",
                    help="profile the runner (or step) under SEUNetConfig(conv_epi=True)")
    ap.add_argument("--trace", type=Path, help="keep the chrome trace here")
    args = ap.parse_args()
    if args.conv_stats and args.conv_epi:
        ap.error("--conv-stats and --conv-epi are two configurations; pick one")
    if not torch.cuda.is_available():
        print("profile_runner: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    call, what = (_train_call if args.train else _runner_call)(args.conv_stats, args.conv_epi)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
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
    print(json.dumps({"profile_train" if args.train else "profile_runner": {
        "card": card, **what, "host_s": wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall_s),
        "device_ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        **({"device_ms_by_backward_node": _by_backward_node(events)} if args.train else {}),
        "top_kernels": [{"name": n[:160], "ms": v[0], "count": v[1]} for n, v in top],
    }}), flush=True)
    return 0 if busy_us > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
