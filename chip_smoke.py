#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (se_unet_airseg_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them. Phases:

1. device: the card's name and power limit (nvidia-smi); TF32 off for
   the float32 phases;
2. build: nvcc builds the epilogue kernels from csrc/epilogue.cu;
3. kernels: each kernel against its plain PyTorch version at the 15
   call shapes of the main path (batch 8, bf16), with its time (CUDA
   events, median of 20 launches), the plain version's time and the
   memory bound of the call;
4. model parity: `apply_fast` in float32 on the card (kernels) against
   the same on the CPU (plain versions) and against the reference-layout
   `apply` on the card, 64^3 tiles, batch 2, at the tolerances of
   tests/test_fast_path.py;
5. main path: `SlidingWindowRunner` (cube 128, step 64, batch 8, bf16,
   full-width random weights from a seed) over a seeded synthetic
   320x256x320 int16 CT phantom with a tubular airway tree: one warm-up
   volume, then TIMED_VOLUMES timed volumes (median reported); the
   kernels' launch counts over the timed volumes must read 10 (gathered)
   and 5 (phased) per tile batch;
6. a `kernels` JSON line, then the card line, then the last line
   `{"ok": true, "device": {...}}`.

Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from se_unet_airseg_tpu_torch.infer import SlidingWindowRunner
from se_unet_airseg_tpu_torch.models import (
    SEUNet,
    SEUNetConfig,
    get_model,
    se_unet_apply,
    se_unet_apply_fast,
)
from se_unet_airseg_tpu_torch.ops import epilogue_s2d as eps

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
BATCH = 8
SHAPE = (320, 256, 320)
TIMED_VOLUMES = 5
# (block, s2d grid n, 8C, gates) of every epilogue call per tile batch of
# 128^3 tiles (n = 64 at the full-resolution level, 32 at the 1/2 level)
GATHERED = [("ec1", 64, 64, 1), ("ec2", 64, 128, 1), ("ec3", 64, 256, 1),
            ("ec33", 64, 256, 0), ("x33", 64, 256, 0), ("ec5", 32, 256, 2),
            ("ec6", 32, 512, 2), ("ec63", 32, 512, 0), ("x63", 32, 512, 0),
            ("dc42", 32, 256, 0)]
PHASED = [("ec4", 32, 256, 2), ("dc3", 32, 512, 2), ("dc4", 32, 256, 2),
          ("dc5", 64, 256, 1), ("dc6", 64, 128, 1)]
KERNELS = {
    "gathered_epilogue": ("se_unet_airseg_tpu/ops/pallas_s2d.py:1156; "
                          "se_unet_airseg_tpu/ops/pallas_s2d.py:761", GATHERED),
    "phased_epilogue": ("se_unet_airseg_tpu/ops/pallas_s2d.py:1854; "
                        "se_unet_airseg_tpu/ops/pallas_s2d.py:518", PHASED),
}
SOURCE = "se_unet_airseg_tpu_torch/csrc/epilogue.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median over `reps` launches of fn's device time (CUDA events)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_mismatch(got: torch.Tensor, ref: torch.Tensor):
    """(max |got - ref|, whether every element is within four bf16 ulps:
    |d| <= 2^-5 |ref| + 2^-12). The kernel keeps the plain version's
    rounding points; only the gate logit sums run in another order, which
    can flip a rounded gate by one ulp and its product by a few."""
    d = (got.float() - ref.float()).abs()
    ok = bool((d <= ref.float().abs() * 2.0 ** -5 + 2.0 ** -12).all())
    return float(d.max()), ok


def kernel_inputs(kind: str, n: int, c8: int, gates: int, gen: torch.Generator):
    dev = torch.device("cuda")
    m = n + 1 if kind == "phased_epilogue" else n
    y = torch.randn((BATCH, m, m, m, c8), generator=gen, device=dev).to(torch.bfloat16)
    scale8 = 0.5 + torch.rand((BATCH, c8), generator=gen, device=dev)
    shift8 = 0.3 * torch.randn((BATCH, c8), generator=gen, device=dev)
    wse = None
    if gates:
        wse = (0.1 * torch.randn((gates, c8 // 8), generator=gen, device=dev)).to(torch.bfloat16)
    return y, scale8, shift8, wse


def bound(y, out_numel: int, c8: int, gates: int):
    """Least time for one call: each input read once, the output written
    once (bytes), against about (4 + 4G) f32 operations per output
    element (affine, LeakyReLU, per gate a multiply-add and a multiply,
    the sigmoid once per C lanes)."""
    nbytes = (y.numel() + out_numel) * y.element_size() + 2 * BATCH * c8 * 4
    ops = out_numel * (4 + 4 * gates)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase():
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    for kind, (_, table) in KERNELS.items():
        kernel = getattr(eps, kind)
        plain = getattr(eps, kind + "_plain")
        agg = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
               "bound_by": "bytes"}
        for block, n, c8, gates in table:
            y, scale8, shift8, wse = kernel_inputs(kind, n, c8, gates, gen)
            got = kernel(y, scale8, shift8, wse)
            ref = plain(y, scale8, shift8, wse)
            torch.cuda.synchronize()
            err, ok = bf16_mismatch(got, ref)
            if not ok or not torch.isfinite(got.float()).all():
                raise AssertionError(f"{kind} {block}: kernel disagrees with its plain "
                                     f"version (max |d| {err})")
            frac = float((got != ref).float().mean())
            ms = cuda_ms(lambda: kernel(y, scale8, shift8, wse))
            plain_ms = cuda_ms(lambda: plain(y, scale8, shift8, wse))
            b_ms, b_by = bound(y, got.numel(), c8, gates)
            emit({"kernel": kind, "block": block, "shape": list(y.shape), "gates": gates,
                  "ms": ms, "bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms,
                  "max_abs_diff": err, "frac_elements_differing": frac})
            agg["ms"] += ms
            agg["plain_ms"] += plain_ms
            agg["bound_ms"] += b_ms
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            if b_by != "bytes":
                agg["bound_by"] = b_by
            del y, got, ref
        summary[kind] = agg
    torch.cuda.empty_cache()
    return summary


def model_parity_phase():
    """f32 apply_fast on the card (kernels) vs on the CPU (plain
    versions) and vs the reference-layout apply on the card."""
    cfg = SEUNetConfig()
    model = SEUNet(cfg, generator=torch.Generator().manual_seed(1))
    tree_cpu = model.params_tree()
    tree_gpu = model.cuda().params_tree()
    x = torch.randn((2, 64, 64, 64, 2), generator=torch.Generator().manual_seed(2))
    eps.reset_launch_counts()
    with torch.inference_mode():
        fast_gpu = se_unet_apply_fast(tree_gpu, x.cuda(), cfg=cfg)
        torch.cuda.synchronize()
        launched = dict(eps.launch_counts)
        ref_gpu = se_unet_apply(tree_gpu, x.cuda(), cfg=cfg)
        fast_cpu = se_unet_apply_fast(tree_cpu, x, cfg=cfg)
        bf16_cfg = SEUNetConfig(compute_dtype=torch.bfloat16)
        fast_bf16 = se_unet_apply_fast(tree_gpu, x.cuda(), cfg=bf16_cfg)
    if launched != {"gathered_epilogue": 10, "phased_epilogue": 5}:
        raise AssertionError(f"f32 apply_fast launched {launched}")
    res = {"launches_f32": launched}
    for name, a, b in (("gpu_vs_cpu", fast_gpu, fast_cpu), ("fast_vs_apply", fast_gpu, ref_gpu)):
        for head, ya, yb in zip(("en", "de"), a, b):
            ya, yb = ya.cpu(), yb.cpu()
            torch.testing.assert_close(ya, yb, rtol=1e-3, atol=1e-4)
            res[f"{name}_{head}_max_abs_diff"] = float((ya - yb).abs().max())
    res["bf16_vs_f32_de_prob_max_abs_diff"] = float(
        (torch.sigmoid(fast_bf16[1]) - torch.sigmoid(fast_gpu[1])).abs().max())
    emit({"model_parity": res})


def phantom(seed: int) -> np.ndarray:
    """Synthetic chest CT, int16 HU+1024: body of soft tissue, two lungs,
    a tubular airway tree (lumen -1000 HU, wall +50 HU), noise."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, h, w = SHAPE
    z, y, x = torch.meshgrid(*(torch.arange(s, device=dev, dtype=torch.float32)
                               for s in SHAPE), indexing="ij")
    hu = torch.full(SHAPE, -1000.0, device=dev)
    body = ((y - h / 2) / (0.45 * h)) ** 2 + ((x - w / 2) / (0.47 * w)) ** 2 < 1
    hu[body] = 40.0
    for cx in (0.3 * w, 0.7 * w):
        lung = (((z - 0.55 * d) / (0.4 * d)) ** 2 + ((y - h / 2) / (0.3 * h)) ** 2
                + ((x - cx) / (0.17 * w)) ** 2) < 1
        hu[lung] = -850.0
    pts = {"t0": (0, h / 2, w / 2), "t1": (0.4 * d, h / 2, w / 2),
           "l": (0.6 * d, 0.5 * h, 0.3 * w), "r": (0.6 * d, 0.5 * h, 0.7 * w),
           "l1": (0.85 * d, 0.35 * h, 0.25 * w), "l2": (0.8 * d, 0.65 * h, 0.2 * w),
           "r1": (0.85 * d, 0.35 * h, 0.75 * w), "r2": (0.8 * d, 0.65 * h, 0.8 * w)}
    segs = [("t0", "t1", 9.0), ("t1", "l", 6.0), ("t1", "r", 6.0), ("l", "l1", 3.5),
            ("l", "l2", 3.5), ("r", "r1", 3.5), ("r", "r2", 3.5)]
    for a, b, r in segs:
        p0 = torch.tensor(pts[a], device=dev)
        v = torch.tensor(pts[b], device=dev) - p0
        t = ((z - p0[0]) * v[0] + (y - p0[1]) * v[1] + (x - p0[2]) * v[2]) / (v @ v)
        t = t.clamp(0, 1)
        dist = torch.sqrt((z - p0[0] - t * v[0]) ** 2 + (y - p0[1] - t * v[1]) ** 2
                          + (x - p0[2] - t * v[2]) ** 2)
        hu[(dist >= r) & (dist < r + 2)] = 50.0
        hu[dist < r] = -1000.0
    hu = hu + 30.0 * torch.randn(SHAPE, generator=gen, device=dev)
    return (hu + 1024.0).clamp(0, 4000).to(torch.int16).cpu().numpy()


def main_path_phase():
    cfg, model = get_model(seed=0, compute_dtype=torch.bfloat16)
    runner = SlidingWindowRunner(model, cfg, cube=128, step=64, batch=BATCH)
    vol = phantom(0)
    kw = dict(h_thresh=0.5, l_thresh=0.35, hu_shift=-1024.0)

    # warm-up volume; record the epilogue calls of one volume to hold the
    # kernel phase's shape table against what the main path really runs
    seen = []
    originals = {k: getattr(eps, k) for k in KERNELS}

    def recorder(kind):
        def call(y, scale8, shift8, wse=None):
            g = 0 if wse is None else wse.shape[0]
            n = y.shape[1] - (1 if kind == "phased_epilogue" else 0)
            seen.append((kind, n, y.shape[-1], g, y.shape[0]))
            return originals[kind](y, scale8, shift8, wse)
        return call

    for k in KERNELS:
        setattr(eps, k, recorder(k))
    try:
        t0 = time.perf_counter()
        runner.predict_trits(vol, **kw)
        warm_s = time.perf_counter() - t0
    finally:
        for k, fn in originals.items():
            setattr(eps, k, fn)
    n_tiles = 48
    n_batches = n_tiles // BATCH
    want = sorted((k, n, c8, g, BATCH) for k, (_, t) in KERNELS.items()
                  for _, n, c8, g in t) * n_batches
    if sorted(seen) != sorted(want):
        raise AssertionError("the main path's epilogue calls differ from the kernel "
                             "phase's shape table")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eps.reset_launch_counts()
    vol_s = []
    for _ in range(TIMED_VOLUMES):
        t0 = time.perf_counter()
        trits = runner.predict_trits(vol, **kw)
        torch.cuda.synchronize()
        vol_s.append(time.perf_counter() - t0)
    launches = dict(eps.launch_counts)
    n_batches *= TIMED_VOLUMES
    if launches != {"gathered_epilogue": 10 * n_batches, "phased_epilogue": 5 * n_batches}:
        raise AssertionError(f"main path launches {launches}, want 10 and 5 per batch")
    if trits.shape != SHAPE or trits.dtype != np.uint8 or trits.max() > 2:
        raise AssertionError(f"bad trit field {trits.shape} {trits.dtype}")
    prob = runner.predict_hu(vol[:128, :128, :128], hu_shift=-1024.0)
    if not np.isfinite(prob).all() or prob.min() < 0 or prob.max() > 1:
        raise AssertionError("non-finite or out-of-range probabilities")
    emit({"main_path": {
        "shape": list(SHAPE), "cube": 128, "step": 64, "batch": BATCH, "dtype": "bfloat16",
        "tiles": n_tiles, "warmup_s": warm_s, "s_per_volume_runs": vol_s,
        "s_per_volume": statistics.median(vol_s),
        "tiles_per_s": n_tiles / statistics.median(vol_s),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "trit_counts": np.bincount(trits.ravel(), minlength=3).tolist()}})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    lib = eps.build_kernels()
    ptxas = [ln for ln in lib.build_log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"build": {"seconds": lib.build_seconds, "library": lib.path.name,
                    "ptxas": ptxas}})

    summary = kernel_phase()
    model_parity_phase()
    launches = main_path_phase()

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": KERNELS[name][0],
         "launches": launches[name], "max_abs_err": agg["max_abs_err"], "ms": agg["ms"],
         "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
         "bound_by": agg["bound_by"], "library_ms": None}
        for name, agg in summary.items()]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
