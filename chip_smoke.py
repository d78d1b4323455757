#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (se_unet_airseg_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them. Phases:

1. device: the card's name and power limit (nvidia-smi); TF32 off for
   the float32 phases;
2. build: nvcc builds the kernels from the six sources under csrc/,
   one nvcc per source, started together, into one library; the line
   reports ptxas's registers and spills of every kernel; for the
   epilogue kernels of csrc/epilogue.cu and the instance_norm_leaky
   kernels (one set for both directions) their registers and spills by
   kernel and the dynamic shared memory of the phased TMA ring per 8C and
   of the norm's bulk-copy ring, with its depth, for each direction; for
   the wgmma kernels of csrc/conv_wgmma.cu (the bf16 `phased_conv_stats`,
   `dil2_dense_conv_stats` and `phased_conv_ungathered`), their registers,
   spills and dynamic shared memory per column tile BN, and for the
   halo-brick wgmma kernel of csrc/dil2_wgmma.cu (the bf16
   `dil2_conv_stats`) its registers and spills per BN and its dynamic
   shared memory at the model's three dil-2 tiles;
3. kernels: the two epilogue kernels against their plain PyTorch
   versions at the 15 call shapes of the inference path (batch 8, bf16),
   with their time (CUDA events, median of 20 launches), the plain
   version's time, the memory bound of the call, `copy_ms` (20
   device-to-device `Tensor.copy_` calls of the same read and write bytes:
   the card's practical floor), the `design` the wrapper picks by shape
   and `designs_ms`, every design of the form timed on the same inputs
   (the first port's per-voxel kernel, persistent 16-byte loads,
   persistent TMA), each held to the chosen design's output first;
4. train kernels: `phased_normalize` at the 5 phased shapes (with
   `design`, `copy_ms` and `designs_ms` as in phase 3) and the fused pool
   backward at the 2 pool shapes of the train step (batch 8, bf16), the
   same way, and the pool backward against autograd of `amax` (the
   library call);
5. model parity: `apply_fast` in float32 on the card (kernels) against
   the same on the CPU (plain versions) and against the reference-layout
   `apply` on the card, 64^3 tiles, batch 2, at the tolerances of
   tests/test_fast_path.py;
6. main path: `SlidingWindowRunner` (cube 128, step 64, batch 8, bf16,
   full-width random weights from a seed) over a seeded synthetic
   320x256x320 int16 CT phantom with a tubular airway tree: one warm-up
   volume, then TIMED_VOLUMES timed volumes (median reported); the
   kernels' launch counts over the timed volumes must read 10 (gathered)
   and 5 (phased) per tile batch;
7. train parity: one float32 stage-1 train step (64^3 crops, batch 2)
   on the card (kernels) against the same step on the CPU (plain
   versions), same weights and DropLayer draws: the loss and every
   gradient at rtol 5e-3, atol 5e-4 (tests/test_fast_path.py), each
   gradient leaf within 2e-2 of its own norm (tests/test_torch_train.py),
   and the launches of the step, 10/5/5/2;
8. train path: `make_train_step(stage=1)` at full width, bf16, AdamW, on
   8 crops of 128^3 cut from the phantom (dual-windowed image, airway
   lumen label): one warm-up step, then TRAIN_STEPS timed steps; the
   launches must read 10/5/5/2 per step, every loss must be finite and
   the batch's loss under one fixed set of DropLayer draws must fall;
9. engine path: the inference entry points (`infer/engine.py`) at full
   width, bf16, the weights of phase 6, in a temporary directory.
   `network_prediction` on the phantom written as a raw-HU NIfTI, with
   cli.predict's defaults (cube 128, step 64, the runner's batch 1):
   seconds by step (preprocess, device from the upload through the trit
   codec, decode, DTI, border suppression + maximum_3d, write, STL), the
   launches (10 gathered and 5 phased per tile batch), whether the native
   host library built, the mask's voxel count (`engine_deployment`); the
   skeleton and STL run on the phantom's airway lumen, since random
   weights give a nearly solid mask.
   The two epilogue kernels at the 15 call shapes at batch 1: the design
   picked by shape, checked as in phase 3 (`engine_batch1_kernels`).
   `network_prediction` in float32 on a 64^3 crop, cube 32, step 16, on
   the card and on the CPU: trits and masks equal except where the CPU's
   averaged score lies within 1e-5 of a threshold (`engine_card_vs_cpu`).
   `run_test`, then `validate(stage=2)`, on two 160^3 cases cut from the
   phantom with priors the phase writes (the port's skeleton of the
   lumen, the tree's 7 segments as the branch map): train mode, a seeded
   CUDA generator, dispatch-ahead depth 1; per case the host seconds of
   its dispatch, its device seconds (CUDA events around the dispatch) and
   host seconds (results ready to metric block), each call's wall
   seconds and whether it is below the device and host sum, whether the
   next case's device work was still running when a case's host work
   began, the launches, every metric finite (`engine_test_validate`);
10. conv_stats kernels: `phased_conv_stats` (the wgmma kernel, `design`
   "wgmma" on its lines) at the 5 phased and `dil2_conv_stats` (the
   halo-brick wgmma kernel, `design` "halo-brick wgmma", with its tile:
   brick 8 x ty x tz voxels, column tile, shared memory) at the 3 dil-2 call
   shapes of the conv_stats configuration (batch 8, bf16) against their
   plain versions: y within
   one bf16 ulp (plus 2^-18 of the sum of |terms|, the f32 reordering
   floor near zero), s1/s2 within 1e-4 of each channel's sum of |y| and
   y^2; with ms, the plain version's ms, the bound (bf16 FLOPs at
   989 TFLOP/s against bytes at 3.35 TB/s) and, as `library_ms`, cuDNN's
   bf16 conv alone (the 2^3 phased kernel, or the port's grouped dil-2
   conv), without gather and sums;
11. conv_stats parity: `apply_fast(SEUNetConfig(conv_stats=True))` in
   float32 on the card against the CPU and against the default
   configuration (64^3, batch 2, rtol 1e-3, atol 1e-4); in bf16 against
   the default configuration on one 128^3 batch of 8 (relative L2 of each
   head at most 5e-2);
12. conv_stats path: the runner of phase 6 under `conv_stats`, one
   warm-up volume and CS_VOLUMES timed volumes; the launches must read 5
   `phased_conv_stats`, 3 `dil2_conv_stats`, 7 gathered and 0 phased
   epilogues per tile batch;
13. conv_epi kernels: `dil2_dense_conv_stats` at the 3 dil-2 and
   `phased_conv_ungathered` at the 5 phased call shapes of the
   conv-to-epilogue configuration (batch 8, bf16; both the wgmma kernel,
   `design` "wgmma"; the dense form on the block-diagonal lift the model
   passes, with its column tile BN and the share of k-step tiles it
   executes) against their plain versions, with the checks of phase 10;
   the dense form's bound counts the weight's nonzeros (`bound_dense_ms`:
   every element); `library_ms` is cuDNN's bf16 conv of the same function
   (the dense block-diagonal conv; the default path's per-input phased
   conv); the dense lines also time K9 on the same block. One more dense
   line, at ec5's shape on a dense random weight, holds the any-weight
   path (not in the kernel's summary: the model does not run it);
14. conv_epi parity: as phase 11, under `SEUNetConfig(conv_epi=True)`;
15. conv_epi path: the runner of phase 6 under `conv_epi`, one warm-up
   volume and CE_VOLUMES timed volumes; the launches must read 3
   `dil2_dense_conv_stats`, 5 `phased_conv_ungathered`, 10 gathered and
   5 phased epilogues per tile batch, and no K8/K9;
16. instance_norm_leaky: its forward and backward kernels against their
   plain versions at (1, 64^3, 256) and at the s2d shape of ec3's output,
   (8, 64^3 * 8, 32), bf16, within one bf16 ulp; with ms, the plain
   version's ms, the memory bound, `copy_ms`, `design` and, as
   `library_ms`, F.instance_norm then F.leaky_relu (two calls; for the
   backward, autograd through them). It has no model path: its launches
   are read from one forward and backward of its s2d entry point under
   autograd;
17. a `kernels` JSON line (each kernel's summed ms, bound, plain and
   library ms, launches, and for K1/K2/K5 and K7 `design` and `copy_ms`),
   then the card line, then the last line `{"ok": true, "device": {...}}`.

Any failure raises and exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from se_unet_airseg_tpu_torch import post
from se_unet_airseg_tpu_torch.data import tile_positions
from se_unet_airseg_tpu_torch.infer import SlidingWindowRunner, engine
from se_unet_airseg_tpu_torch.infer import sliding_window as psw
from se_unet_airseg_tpu_torch.io import read_nifti, write_nifti
from se_unet_airseg_tpu_torch.pipeline.preprocess import load_canonical
from se_unet_airseg_tpu_torch.post import mesh as post_mesh
from se_unet_airseg_tpu_torch.models import (
    SEUNet,
    SEUNetConfig,
    get_model,
    se_unet_apply,
    se_unet_apply_fast,
)
from se_unet_airseg_tpu_torch.models.se_unet import _DIL2_NG, _leaves, _tree_map
from se_unet_airseg_tpu_torch.ops import build_kernels, conv3d, hu_dual_window, launch_counts
from se_unet_airseg_tpu_torch.ops import conv_stats as pcs
from se_unet_airseg_tpu_torch.ops import epilogue_s2d as eps
from se_unet_airseg_tpu_torch.ops import norm_leaky, reset_launch_counts
from se_unet_airseg_tpu_torch.ops import s2d as ps2d
from se_unet_airseg_tpu_torch.train import (
    create_train_state,
    make_loss_fn,
    make_optimizer,
    make_train_step,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM bf16 tensor cores, dense
BATCH = 8
SHAPE = (320, 256, 320)
TIMED_VOLUMES = 5
CS_VOLUMES = 3
CE_VOLUMES = 3
TRAIN_STEPS = 10
# (block, s2d grid n, 8C, gates) of every epilogue call per tile batch of
# 128^3 tiles (n = 64 at the full-resolution level, 32 at the 1/2 level)
GATHERED = [("ec1", 64, 64, 1), ("ec2", 64, 128, 1), ("ec3", 64, 256, 1),
            ("ec33", 64, 256, 0), ("x33", 64, 256, 0), ("ec5", 32, 256, 2),
            ("ec6", 32, 512, 2), ("ec63", 32, 512, 0), ("x63", 32, 512, 0),
            ("dc42", 32, 256, 0)]
PHASED = [("ec4", 32, 256, 2), ("dc3", 32, 512, 2), ("dc4", 32, 256, 2),
          ("dc5", 64, 256, 1), ("dc6", 64, 128, 1)]
# (tensor, s2d grid n, 8C) of the two pools that carry a gradient per
# train batch of 128^3 crops
POOLS = [("e1", 64, 256), ("e3s", 32, 512)]
# conv_stats calls per tile batch: (block, n, input lanes of each input,
# Co) of the phased blocks; (block, n, Ci, Co) of the dil-2 blocks
CS_PHASED = [("ec4", 32, (256,), 32), ("dc3", 32, (512, 512), 64), ("dc4", 32, (512,), 32),
             ("dc5", 64, (256, 256), 32), ("dc6", 64, (256,), 16)]
CS_DIL2 = [("ec3", 64, 16, 32), ("ec5", 32, 32, 32), ("ec6", 32, 32, 64)]
# conv_epi calls per tile batch: the same blocks as (block, n, input lanes
# of each input, 8Co) and (block, n, C8, C8o)
CE_PHASED = [(blk, n, cis, 8 * co) for blk, n, cis, co in CS_PHASED]
CE_DIL2 = [(blk, n, 8 * ci, 8 * co) for blk, n, ci, co in CS_DIL2]
# instance_norm_leaky: (name, shape) of the shape its docstring names and
# the s2d form of ec3's output
NL_SHAPES = [("docstring", (1, 64 ** 3, 256)), ("ec3_s2d", (BATCH, 64 ** 3 * 8, 32))]
WGMMA_SRC = "se_unet_airseg_tpu_torch/csrc/conv_wgmma.cu"
DIL2_SRC = "se_unet_airseg_tpu_torch/csrc/dil2_wgmma.cu"
NL_SRC = "se_unet_airseg_tpu_torch/csrc/norm_leaky.cu"
EPI_SRC = "se_unet_airseg_tpu_torch/csrc/epilogue.cu"
KERNELS = {  # name: (the Pallas functions it replaces, source)
    "gathered_epilogue": ("se_unet_airseg_tpu/ops/pallas_s2d.py:1156; "
                          "se_unet_airseg_tpu/ops/pallas_s2d.py:761", EPI_SRC),
    "phased_epilogue": ("se_unet_airseg_tpu/ops/pallas_s2d.py:1854; "
                        "se_unet_airseg_tpu/ops/pallas_s2d.py:518", EPI_SRC),
    "phased_normalize": ("se_unet_airseg_tpu/ops/pallas_s2d.py:581", EPI_SRC),
    "max_pool_s2d_bwd": ("se_unet_airseg_tpu/ops/pallas_s2d.py:671",
                         "se_unet_airseg_tpu_torch/csrc/pool_s2d.cu"),
    "phased_conv_stats": ("se_unet_airseg_tpu/ops/pallas_s2d.py:1082", WGMMA_SRC),
    "dil2_conv_stats": ("se_unet_airseg_tpu/ops/pallas_s2d.py:405", DIL2_SRC),
    "dil2_dense_conv_stats": ("se_unet_airseg_tpu/ops/pallas_s2d.py:1714", WGMMA_SRC),
    "phased_conv_ungathered": ("se_unet_airseg_tpu/ops/pallas_s2d.py:2179; "
                               "se_unet_airseg_tpu/ops/pallas_s2d.py:2131", WGMMA_SRC),
    "instance_norm_leaky_fwd": ("se_unet_airseg_tpu/ops/pallas_norm.py:132", NL_SRC),
    "instance_norm_leaky_bwd": ("se_unet_airseg_tpu/ops/pallas_norm.py:168", NL_SRC),
}
EPILOGUE_TABLES = {"gathered_epilogue": GATHERED, "phased_epilogue": PHASED}
# engine path: the 160^3 test / validation cases cut from the phantom
# (origins), and the 64^3 crop held card against CPU
ENGINE_CUT = 160
ENGINE_CASES = {"CASE_a": (48, 48, 80), "CASE_b": (160, 48, 40)}
CMP_CROP = (slice(96, 160), slice(96, 160), slice(128, 192))


def ptxas_report(log: str) -> dict:
    """ptxas's register and spill lines (and any line on wgmma) of each
    kernel in an `nvcc -Xptxas -v` log, by mangled kernel name."""
    report, name = {}, None
    for ln in log.splitlines():
        marks = [m for m in ("Compiling entry function '", "Function properties for ")
                 if m in ln]
        if marks:
            name = ln.split(marks[0], 1)[1].split("'")[0].strip()
        elif name and ("registers" in ln or "spill" in ln or "wgmma" in ln):
            report.setdefault(name, []).append(ln.strip())
    return report


def wgmma_report(ptxas: dict) -> dict:
    """The wgmma kernels' ptxas lines, keyed kernel<BN>."""
    out = {}
    for name, lines in ptxas.items():
        for kernel in ("phased_conv_stats_wgmma", "phased_conv_ungathered_wgmma",
                       "dil2_dense_conv_stats_wgmma", "dil2_conv_stats_wgmma"):
            m = re.search(kernel + r"ILi(\d+)E", name)
            if m:
                out[f"{kernel}<{m.group(1)}>"] = lines
    return out


def named_report(ptxas: dict, kernels) -> dict:
    """The ptxas lines of every instance of `kernels`, by mangled name."""
    return {name: lines for name, lines in ptxas.items() if any(k in name for k in kernels)}


def counts(**nonzero) -> dict:
    """Every kernel's launch count: `nonzero`, 0 for the others."""
    return {k: nonzero.get(k, 0) for k in launch_counts}


STEP_LAUNCHES = counts(gathered_epilogue=10, phased_epilogue=5, phased_normalize=5,
                       max_pool_s2d_bwd=2)
CS_LAUNCHES = counts(gathered_epilogue=7, phased_conv_stats=5, dil2_conv_stats=3)
CE_LAUNCHES = counts(gathered_epilogue=10, phased_epilogue=5, dil2_dense_conv_stats=3,
                     phased_conv_ungathered=5)


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


def copy_ms(nbytes: int) -> float:
    """The card's practical memory floor for a call that moves `nbytes`
    (reads plus writes): the median of 20 device-to-device
    `Tensor.copy_` calls of nbytes / 2 bytes each way."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src))
    del src, dst
    return ms


def design_ms(kernel, phased: bool, *args) -> dict:
    """ms of each design of the form (`eps.designs`) on the same inputs,
    each first held to the chosen design's output (bf16: the four-ulp
    check, the gate logits may sum in another order)."""
    ref = kernel(*args)
    out = {}
    for name in eps.designs(phased):
        got = kernel(*args, design=name)
        if not bf16_mismatch(got, ref)[1]:
            raise AssertionError(f"design {name} disagrees with the chosen design")
        out[name] = cuda_ms(lambda: kernel(*args, design=name))
    return out


def bf16_mismatch(got: torch.Tensor, ref: torch.Tensor):
    """(max |got - ref|, whether every element is within four bf16 ulps:
    |d| <= 2^-5 |ref| + 2^-12). The kernel keeps the plain version's
    rounding points; only the gate logit sums run in another order, which
    can flip a rounded gate by one ulp and its product by a few."""
    d = (got.float() - ref.float()).abs()
    ok = bool((d <= ref.float().abs() * 2.0 ** -5 + 2.0 ** -12).all())
    return float(d.max()), ok


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element of ref (8 significant bits)."""
    r = ref.float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    return torch.where(r == 0, torch.full_like(r, 2.0 ** -133), ulp)


def kernel_inputs(kind: str, n: int, c8: int, gates: int, gen: torch.Generator,
                  batch: int = BATCH):
    dev = torch.device("cuda")
    m = n + 1 if kind == "phased_epilogue" else n
    y = torch.randn((batch, m, m, m, c8), generator=gen, device=dev).to(torch.bfloat16)
    scale8 = 0.5 + torch.rand((batch, c8), generator=gen, device=dev)
    shift8 = 0.3 * torch.randn((batch, c8), generator=gen, device=dev)
    wse = None
    if gates:
        wse = (0.1 * torch.randn((gates, c8 // 8), generator=gen, device=dev)).to(torch.bfloat16)
    return y, scale8, shift8, wse


def least_ms(nbytes: float, ops: float):
    """(least ms, what binds it): bytes at the memory rate against f32
    operations at the f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(elt: int, out_numel: int, c8: int, gates: int):
    """Least time for one epilogue call: the elements the output needs
    read once (one per output element: the phased form reads only its 8
    shifted n^3 windows of the (n+1)^3 conv output), scale8/shift8 and
    the gate vectors read once, the output written once (bytes), against
    about (4 + 4G) f32 operations per output element (affine, LeakyReLU,
    per gate a multiply-add and a multiply, the sigmoid once per C
    lanes)."""
    nbytes = (2 * out_numel + gates * c8 // 8) * elt + 2 * BATCH * c8 * 4
    return least_ms(nbytes, out_numel * (4 + 4 * gates))


def new_summary():
    return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
            "bound_by": "bytes", "library_ms": None}


def add_call(agg: dict, line: dict) -> None:
    """Sum one call's line into its kernel's per-step summary."""
    for k in ("ms", "plain_ms", "bound_ms"):
        agg[k] += line[k]
    if line.get("library_ms") is not None:
        agg["library_ms"] = (agg["library_ms"] or 0.0) + line["library_ms"]
    if "copy_ms" in line:
        agg["copy_ms"] = agg.get("copy_ms", 0.0) + line["copy_ms"]
    if "design" in line:
        agg["design"] = line["design"] if agg.get("design", line["design"]) == line["design"] \
            else "by shape"
    agg["max_abs_err"] = max(agg["max_abs_err"], line["max_abs_diff"])
    if line["bound_by"] != "bytes":
        agg["bound_by"] = line["bound_by"]


def kernel_phase():
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    for kind, table in EPILOGUE_TABLES.items():
        kernel = getattr(eps, kind)
        plain = getattr(eps, kind + "_plain")
        agg = new_summary()
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
            b_ms, b_by = bound(y.element_size(), got.numel(), c8, gates)
            line = {"kernel": kind, "block": block, "shape": list(y.shape), "gates": gates,
                    "design": eps.pick_design(y, kind == "phased_epilogue"),
                    "ms": ms, "bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms,
                    "copy_ms": copy_ms(2 * got.numel() * got.element_size()),
                    "designs_ms": design_ms(kernel, kind == "phased_epilogue", y, scale8,
                                            shift8, wse),
                    "max_abs_diff": err, "frac_elements_differing": frac}
            line["x_bound"] = ms / b_ms
            emit(line)
            add_call(agg, line)
            del y, got, ref
        summary[kind] = agg
    torch.cuda.empty_cache()
    return summary


def pool_input(n: int, c8: int, gen: torch.Generator) -> torch.Tensor:
    """bf16 (B, n, n, n, 8C) pool input with ties among the 8
    sub-positions: on every third channel sub-positions 3 and 6 copy 1,
    on every seventh all 8 are equal."""
    x8 = torch.randn((BATCH, n, n, n, 8, c8 // 8), generator=gen, device="cuda")
    x8[..., 3, ::3] = x8[..., 1, ::3]
    x8[..., 6, ::3] = x8[..., 1, ::3]
    x8[..., :, ::7] = x8[..., :1, ::7]
    return x8.flatten(-2).to(torch.bfloat16)


def train_kernel_phase():
    """phased_normalize at the 5 phased shapes and the fused pool
    backward at the 2 pool shapes of one train step, each against its
    plain version (normalize within one bf16 ulp; pool exact, one ulp
    where a tie divides); the pool also against autograd of amax."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    summary = {"phased_normalize": new_summary(), "max_pool_s2d_bwd": new_summary()}
    for block, n, c8, _ in PHASED:
        y, scale8, shift8, _ = kernel_inputs("phased_epilogue", n, c8, 0, gen)
        got = eps.phased_normalize(y, scale8, shift8)
        ref = eps.phased_normalize_plain(y, scale8, shift8)
        d = (got.float() - ref.float()).abs()
        if not bool((d <= bf16_ulp(ref)).all()) or not torch.isfinite(got.float()).all():
            raise AssertionError(f"phased_normalize {block}: kernel disagrees with its "
                                 f"plain version (max |d| {float(d.max())})")
        b_ms, b_by = bound(y.element_size(), got.numel(), c8, 0)
        line = {"kernel": "phased_normalize", "block": block, "shape": list(y.shape),
                "design": eps.pick_design(y, True, normalize=True),
                "ms": cuda_ms(lambda: eps.phased_normalize(y, scale8, shift8)),
                "bound_ms": b_ms, "bound_by": b_by,
                "plain_ms": cuda_ms(lambda: eps.phased_normalize_plain(y, scale8, shift8)),
                "copy_ms": copy_ms(2 * got.numel() * got.element_size()),
                "designs_ms": design_ms(eps.phased_normalize, True, y, scale8, shift8),
                "max_abs_diff": float(d.max()),
                "frac_elements_differing": float((d > 0).float().mean())}
        line["x_bound"] = line["ms"] / b_ms
        emit(line)
        add_call(summary["phased_normalize"], line)
        del y, got, ref, d
    for block, n, c8 in POOLS:
        x = pool_input(n, c8, gen)
        g = torch.randn((BATCH, n, n, n, c8 // 8), generator=gen, device="cuda")
        g = g.to(torch.bfloat16)
        x8 = x.unflatten(-1, (8, c8 // 8))
        tie = ((x8 == x8.amax(-2, keepdim=True)).sum(-2, keepdim=True) > 1)
        tie = tie.expand_as(x8).flatten(-2)
        err = 0.0
        for gg in (None, g):  # the mask form, then the fused form the path runs
            got = ps2d.max_pool_s2d_bwd(x, gg)
            ref = ps2d.max_pool_s2d_bwd_plain(x, gg)
            d = (got.float() - ref.float()).abs()
            if bool((d[~tie] > 0).any()) or not bool((d <= bf16_ulp(ref)).all()):
                raise AssertionError(f"max_pool_s2d_bwd {block} (g={gg is not None}): "
                                     f"kernel disagrees with its plain version")
            err = max(err, float(d.max()))
        xr = x.detach().requires_grad_(True)
        amax = xr.unflatten(-1, (8, c8 // 8)).amax(-2)

        def library():
            return torch.autograd.grad(amax, xr, g, retain_graph=True)[0]

        lib_d = float((library().float() - got.float()).abs().max())
        b_ms, b_by = least_ms((x.numel() + g.numel() + got.numel()) * 2, 4 * got.numel())
        line = {"kernel": "max_pool_s2d_bwd", "block": block, "shape": list(x.shape),
                "ms": cuda_ms(lambda: ps2d.max_pool_s2d_bwd(x, g)),
                "bound_ms": b_ms, "bound_by": b_by,
                "plain_ms": cuda_ms(lambda: ps2d.max_pool_s2d_bwd_plain(x, g)),
                "library_ms": cuda_ms(library), "library_max_abs_diff": lib_d,
                "max_abs_diff": err, "tie_share": float(tie.float().mean())}
        emit(line)
        add_call(summary["max_pool_s2d_bwd"], line)
        del x, g, x8, tie, got, ref, d, xr, amax
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
    reset_launch_counts()
    with torch.inference_mode():
        fast_gpu = se_unet_apply_fast(tree_gpu, x.cuda(), cfg=cfg)
        torch.cuda.synchronize()
        launched = dict(launch_counts)
        ref_gpu = se_unet_apply(tree_gpu, x.cuda(), cfg=cfg)
        fast_cpu = se_unet_apply_fast(tree_cpu, x, cfg=cfg)
        bf16_cfg = SEUNetConfig(compute_dtype=torch.bfloat16)
        fast_bf16 = se_unet_apply_fast(tree_gpu, x.cuda(), cfg=bf16_cfg)
    if launched != counts(gathered_epilogue=10, phased_epilogue=5):
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


def phantom(seed: int):
    """Synthetic chest CT, int16 HU+1024: body of soft tissue, two lungs,
    a tubular airway tree of 7 segments (lumen -1000 HU, wall +50 HU),
    noise. Returns (volume as numpy, airway lumen mask as a bool tensor on
    the card, the lumen's segment labels 1..7 as int16 numpy: a branch map
    by construction, kept off the card)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, h, w = SHAPE
    z, y, x = torch.meshgrid(*(torch.arange(s, device=dev, dtype=torch.float32)
                               for s in SHAPE), indexing="ij")
    hu = torch.full(SHAPE, -1000.0, device=dev)
    lumen = torch.zeros(SHAPE, dtype=torch.bool, device=dev)
    branch = torch.zeros(SHAPE, dtype=torch.int16, device=dev)
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
    for label, (a, b, r) in enumerate(segs, start=1):
        p0 = torch.tensor(pts[a], device=dev)
        v = torch.tensor(pts[b], device=dev) - p0
        t = ((z - p0[0]) * v[0] + (y - p0[1]) * v[1] + (x - p0[2]) * v[2]) / (v @ v)
        t = t.clamp(0, 1)
        dist = torch.sqrt((z - p0[0] - t * v[0]) ** 2 + (y - p0[1] - t * v[1]) ** 2
                          + (x - p0[2] - t * v[2]) ** 2)
        hu[(dist >= r) & (dist < r + 2)] = 50.0
        hu[dist < r] = -1000.0
        lumen |= dist < r
        branch[dist < r] = label
    hu = hu + 30.0 * torch.randn(SHAPE, generator=gen, device=dev)
    return (hu + 1024.0).clamp(0, 4000).to(torch.int16).cpu().numpy(), lumen, \
        branch.cpu().numpy()


def main_path_phase(vol: np.ndarray):
    cfg, model = get_model(seed=0, compute_dtype=torch.bfloat16)
    runner = SlidingWindowRunner(model, cfg, cube=128, step=64, batch=BATCH)
    kw = dict(h_thresh=0.5, l_thresh=0.35, hu_shift=-1024.0)

    # warm-up volume; record the epilogue calls of one volume to hold the
    # kernel phase's shape table against what the main path really runs
    seen = []
    originals = {k: getattr(eps, k) for k in EPILOGUE_TABLES}

    def recorder(kind):
        def call(y, scale8, shift8, wse=None):
            g = 0 if wse is None else wse.shape[0]
            n = y.shape[1] - (1 if kind == "phased_epilogue" else 0)
            seen.append((kind, n, y.shape[-1], g, y.shape[0]))
            return originals[kind](y, scale8, shift8, wse)
        return call

    for k in EPILOGUE_TABLES:
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
    want = sorted((k, n, c8, g, BATCH) for k, t in EPILOGUE_TABLES.items()
                  for _, n, c8, g in t) * n_batches
    if sorted(seen) != sorted(want):
        raise AssertionError("the main path's epilogue calls differ from the kernel "
                             "phase's shape table")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    vol_s = []
    for _ in range(TIMED_VOLUMES):
        t0 = time.perf_counter()
        trits = runner.predict_trits(vol, **kw)
        torch.cuda.synchronize()
        vol_s.append(time.perf_counter() - t0)
    launches = dict(launch_counts)
    n_batches *= TIMED_VOLUMES
    if launches != counts(gathered_epilogue=10 * n_batches, phased_epilogue=5 * n_batches):
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
    return launches, trits


def cs_bound(flops: float, nbytes: float):
    """(least ms, what binds it): bf16 FLOPs at the tensor-core peak
    against bytes at the memory rate."""
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_stats_call(name, block, shape, kernel, plain, mag, library, flops, nbytes, agg,
                    library_label="cuDNN bf16 conv only: no phase gather, no sums",
                    design=None, fields=None, **extra):
    """Hold one conv call against its plain version, time it, and emit its
    line: y within one bf16 ulp plus 2^-18 of the sum of |terms| `mag`
    (the two sum in f32 in another order, which near zero moves y by more
    than an ulp); s1, s2, where the kernel returns them, within 1e-4 of
    each channel's sum of |y| and of y^2. `extra`: more timed calls on the
    same inputs, name -> fn, reported as name_ms; `design` names the
    kernel's design on the line; `fields` are more entries of the line.
    The line is summed into `agg` unless that is None."""
    got, ref = kernel(), plain()
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    y, ry = got[0], ref[0]
    m = mag().float()
    torch.cuda.synchronize()
    d = (y.float() - ry.float()).abs()
    y_ok = bool((d <= bf16_ulp(ry) + 2.0 ** -18 * m).all())
    ryf = ry.float()
    s_err = 0.0
    s_ok = True
    for s, rs, mags in zip(got[1:], ref[1:], (ryf.abs(), ryf.square())):
        lim = 1e-4 * mags.sum(dim=(1, 2, 3))
        s_ok &= bool(((s - rs).abs() <= lim).all())
        s_err = max(s_err, float(((s - rs).abs() / lim).max()))
    del m, ryf
    if not (y_ok and s_ok and torch.isfinite(y.float()).all()):
        raise AssertionError(f"{name} {block}: kernel disagrees with its plain version "
                             f"(max |dy| {float(d.max())}, sums at {s_err} of the limit)")
    frac = float((d > 0).float().mean())
    err = float(d.max())
    has_sums = len(got) > 1
    del got, ref, y, ry, d
    ms = cuda_ms(kernel)
    b_ms, b_by = cs_bound(flops, nbytes)
    line = {"kernel": name, "block": block, "shape": shape, "ms": ms, "bound_ms": b_ms,
            "bound_by": b_by, "x_bound": ms / b_ms, "tflops": flops / ms / 1e9,
            "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
            "library": library_label, "max_abs_diff": err, "frac_elements_differing": frac,
            **({"sums_err_of_limit": s_err} if has_sums else {}),
            **({"design": design} if design else {}), **(fields or {}),
            **{f"{k}_ms": cuda_ms(fn) for k, fn in extra.items()}}
    emit(line)
    if agg is not None:
        add_call(agg, line)


def conv_stats_kernel_phase():
    """phased_conv_stats at its 5 and dil2_conv_stats at its 3 call
    shapes of the conv_stats configuration (batch 8, bf16, seeded
    inputs), each against its plain version; the library call is cuDNN's
    bf16 conv of the same kernel (K8: the 2^3 phased kernel on the concat;
    K9: the port's grouped dil-2 conv)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    bf = torch.bfloat16
    summary = {"phased_conv_stats": new_summary(), "dil2_conv_stats": new_summary()}

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    for block, n, cis, co in CS_PHASED:
        xs = [randn(BATCH, n, n, n, c).to(bf) for c in cis]
        cin, vox = sum(cis), BATCH * n ** 3
        w = randn(8, cin, 8 * co, scale=1 / math.sqrt(8 * cin)).to(bf)
        b = randn(8 * co, scale=0.1)
        xcat = torch.cat(xs, dim=-1)
        w5 = w.reshape(2, 2, 2, cin, 8 * co)
        conv_stats_call(
            "phased_conv_stats", block, [BATCH, n, n, n, list(cis), 8 * co],
            lambda: pcs.phased_conv_stats(xs, w, b),
            lambda: pcs.phased_conv_stats_plain(xs, w, b),
            lambda: pcs.phased_conv_stats_plain([t.abs() for t in xs], w.abs(), 0 * b)[0],
            lambda: conv3d(xcat, w5, padding=1),
            2 * vox * 8 * cin * 8 * co,
            2 * (vox * cin + vox * 8 * co + w.numel()) + 4 * (b.numel() + 2 * BATCH * 8 * co),
            summary["phased_conv_stats"], design="wgmma")
        del xs, w, b, xcat, w5
        torch.cuda.empty_cache()
    for block, n, ci, co in CS_DIL2:
        x = randn(BATCH, n, n, n, 8 * ci).to(bf)
        vox = BATCH * n ** 3
        w = randn(3, 3, 3, ci, co, scale=1 / math.sqrt(27 * ci)).to(bf)
        b = randn(co, scale=0.1)
        ng = _DIL2_NG[block]
        wg = ps2d.dil2_group_weight(w, ng, bf)
        conv_stats_call(
            "dil2_conv_stats", block, [BATCH, n, n, n, 8 * ci, 8 * co],
            lambda: pcs.dil2_conv_stats(x, w, b),
            lambda: pcs.dil2_conv_stats_plain(x, w, b),
            lambda: pcs.dil2_conv_stats_plain(x.abs(), w.abs(), 0 * b)[0],
            lambda: conv3d(x, wg, padding=1, groups=ng),
            2 * vox * 8 * 27 * ci * co,
            2 * (vox * 8 * ci + vox * 8 * co + w.numel()) + 4 * (co + 2 * BATCH * 8 * co),
            summary["dil2_conv_stats"], design="halo-brick wgmma",
            fields=dict(zip(("ty", "tz", "bn", "smem_bytes"), pcs.dil2_tile(ci, co))))
        del x, w, b, wg
        torch.cuda.empty_cache()
    return summary


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def config_parity_phase(name: str, cfg_c: SEUNetConfig, want: dict):
    """apply_fast under the configuration `cfg_c`: f32 on the card
    (kernels) against the CPU (plain versions) and against the default
    configuration on the card, 64^3, batch 2, with the launches `want`;
    bf16 against the default configuration on one 128^3 batch of 8."""
    cfg_d = SEUNetConfig()
    model = SEUNet(cfg_d, generator=torch.Generator().manual_seed(1))
    tree_cpu = model.params_tree()
    tree_gpu = model.cuda().params_tree()
    x = torch.randn((2, 64, 64, 64, 2), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        reset_launch_counts()
        cs_gpu = se_unet_apply_fast(tree_gpu, x.cuda(), cfg=cfg_c)
        torch.cuda.synchronize()
        launched = dict(launch_counts)
        cs_cpu = se_unet_apply_fast(tree_cpu, x, cfg=cfg_c)
        d_gpu = se_unet_apply_fast(tree_gpu, x.cuda(), cfg=cfg_d)
    if launched != want:
        raise AssertionError(f"f32 {name} apply_fast launched {launched}")
    res = {"launches_f32": launched}
    for cmp, a, b in (("gpu_vs_cpu", cs_gpu, cs_cpu), ("vs_default", cs_gpu, d_gpu)):
        for head, ya, yb in zip(("en", "de"), a, b):
            ya, yb = ya.cpu(), yb.cpu()
            torch.testing.assert_close(ya, yb, rtol=1e-3, atol=1e-4)
            res[f"f32_{cmp}_{head}_max_abs_diff"] = float((ya - yb).abs().max())
    bf = torch.bfloat16
    xb = torch.randn((BATCH, 128, 128, 128, 2), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        a = se_unet_apply_fast(tree_gpu, xb.cuda(), cfg=dataclasses.replace(cfg_c, compute_dtype=bf))
        b = se_unet_apply_fast(tree_gpu, xb.cuda(), cfg=dataclasses.replace(cfg_d, compute_dtype=bf))
    for head, ya, yb in zip(("en", "de"), a, b):
        res[f"bf16_vs_default_{head}_max_abs_diff"] = float((ya - yb).abs().max())
        res[f"bf16_vs_default_{head}_rel_l2"] = rel_l2(ya, yb)
    emit({f"{name}_parity": res})
    for head in ("en", "de"):
        if not res[f"bf16_vs_default_{head}_rel_l2"] <= 5e-2:
            raise AssertionError(f"bf16 {name} {head} head differs from the default "
                                 f"configuration: relative L2 {res[f'bf16_vs_default_{head}_rel_l2']}")
    del a, b, xb, tree_gpu, model
    torch.cuda.empty_cache()


def config_path_phase(name: str, vol: np.ndarray, default_trits: np.ndarray, volumes: int,
                      want: dict, **cfg_kw):
    """The main path's runner under `SEUNetConfig(**cfg_kw)`: one warm-up
    volume, then `volumes` timed volumes; the launches must read `want`
    per tile batch; the trits are compared with the default
    configuration's."""
    cfg, model = get_model(seed=0, compute_dtype=torch.bfloat16)
    cfg = dataclasses.replace(cfg, **cfg_kw)
    runner = SlidingWindowRunner(model, cfg, cube=128, step=64, batch=BATCH)
    kw = dict(h_thresh=0.5, l_thresh=0.35, hu_shift=-1024.0)
    t0 = time.perf_counter()
    runner.predict_trits(vol, **kw)
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    vol_s = []
    for _ in range(volumes):
        t0 = time.perf_counter()
        trits = runner.predict_trits(vol, **kw)
        torch.cuda.synchronize()
        vol_s.append(time.perf_counter() - t0)
    launches = dict(launch_counts)
    n_tiles = 48
    n_batches = n_tiles // BATCH * volumes
    if launches != {k: v * n_batches for k, v in want.items()}:
        raise AssertionError(f"{name} path launches {launches}, want {want} per batch")
    if trits.shape != SHAPE or trits.dtype != np.uint8 or trits.max() > 2:
        raise AssertionError(f"bad trit field {trits.shape} {trits.dtype}")
    prob = runner.predict_hu(vol[:128, :128, :128], hu_shift=-1024.0)
    if not np.isfinite(prob).all() or prob.min() < 0 or prob.max() > 1:
        raise AssertionError("non-finite or out-of-range probabilities")
    emit({f"{name}_path": {
        "shape": list(SHAPE), "cube": 128, "step": 64, "batch": BATCH, "dtype": "bfloat16",
        "tiles": n_tiles, "warmup_s": warm_s, "s_per_volume_runs": vol_s,
        "s_per_volume": statistics.median(vol_s),
        "tiles_per_s": n_tiles / statistics.median(vol_s),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "trit_counts": np.bincount(trits.ravel(), minlength=3).tolist(),
        "trits_equal_to_default_share": float((trits == default_trits).mean())}})
    del runner, model
    torch.cuda.empty_cache()
    return launches


def dense_call(block, n, c8, c8o, x, wd, bg, agg, **extra):
    """One `dil2_dense_conv_stats` call shape through `conv_stats_call`:
    the bound counts the weight's nonzeros (what this weight needs),
    `bound_dense_ms` every element; the line names the kernel's column
    tile BN and the share of k-step tiles it executes."""
    pcs.dil2_dense_conv_stats(x, wd, bg)
    plan = pcs.dense_tiles
    executed = int(plan["count"].sum()) / (plan["count"].numel() * plan["nsteps"])
    vox = BATCH * n ** 3
    nbytes = 2 * (vox * c8 + vox * c8o + wd.numel()) + 4 * (c8o + 2 * BATCH * c8o)
    conv_stats_call(
        "dil2_dense_conv_stats", block, [BATCH, n, n, n, c8, c8o],
        lambda: pcs.dil2_dense_conv_stats(x, wd, bg),
        lambda: pcs.dil2_dense_conv_stats_plain(x, wd, bg),
        lambda: pcs.dil2_dense_conv_stats_plain(x.abs(), wd.abs(), 0 * bg)[0],
        lambda: conv3d(x, wd, padding=1),
        2 * vox * int((wd != 0).sum()), nbytes, agg,
        library_label="cuDNN bf16 dense conv with the same weight, no sums", design="wgmma",
        fields={"bn": plan["bn"], "executed_tile_share": executed,
                "bound_dense_ms": cs_bound(2 * vox * 27 * c8 * c8o, nbytes)[0]}, **extra)


def conv_epi_kernel_phase():
    """dil2_dense_conv_stats at its 3 and phased_conv_ungathered at its 5
    call shapes of the conv_epi configuration (batch 8, bf16, seeded
    inputs), each against its plain version with the checks of the
    conv_stats phase. The dense form gets the block-diagonal lift of a
    random dil-2 kernel, as the model gives it, and skips its all-zero
    k-step tiles; its library call is cuDNN's bf16 conv with the same
    weight, and K9's time on the same block is reported beside it. One
    more dense call, at ec5's shape on a dense random weight, is held to
    the same checks and not summed. The ungathered conv's library call is
    the default path's cuDNN phased conv."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    bf = torch.bfloat16
    summary = {"dil2_dense_conv_stats": new_summary(), "phased_conv_ungathered": new_summary()}

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    for block, n, c8, c8o in CE_DIL2:
        x = randn(BATCH, n, n, n, c8).to(bf)
        w = randn(3, 3, 3, c8 // 8, c8o // 8, scale=1 / math.sqrt(27 * c8 // 8)).to(bf)
        b = randn(c8o // 8, scale=0.1)
        wd = ps2d.dil2_dense_weight(w, bf)
        dense_call(block, n, c8, c8o, x, wd, b.repeat(8), summary["dil2_dense_conv_stats"],
                   k9_same_block=lambda: pcs.dil2_conv_stats(x, w, b))
        del x, w, b, wd
        torch.cuda.empty_cache()
    block, n, c8, c8o = next(c for c in CE_DIL2 if c[0] == "ec5")
    x = randn(BATCH, n, n, n, c8).to(bf)
    wd = randn(3, 3, 3, c8, c8o, scale=1 / math.sqrt(27 * c8)).to(bf)
    dense_call(block + "_dense_weight", n, c8, c8o, x, wd, randn(c8o, scale=0.1), None)
    del x, wd
    torch.cuda.empty_cache()
    for block, n, cis, c8o in CE_PHASED:
        xs = [randn(BATCH, n, n, n, c).to(bf) for c in cis]
        cin, m = sum(cis), n + 1
        w = randn(2, 2, 2, cin, c8o, scale=1 / math.sqrt(8 * cin)).to(bf)
        b = randn(c8o, scale=0.1)
        conv_stats_call(
            "phased_conv_ungathered", block, [BATCH, n, n, n, list(cis), c8o],
            lambda: pcs.phased_conv_ungathered(xs, w, b),
            lambda: pcs.phased_conv_ungathered_plain(xs, w, b),
            lambda: pcs.phased_conv_ungathered_plain([t.abs() for t in xs], w.abs()),
            lambda: ps2d.phased_conv_ext(xs, w, b.to(bf)),
            2 * BATCH * m ** 3 * 8 * cin * c8o,
            2 * (BATCH * n ** 3 * cin + BATCH * m ** 3 * c8o + w.numel()) + 4 * c8o,
            summary["phased_conv_ungathered"], design="wgmma",
            library_label="cuDNN bf16 phased conv of the default path (per-input partial sums)")
        del xs, w, b
        torch.cuda.empty_cache()
    return summary


def norm_leaky_phase():
    """instance_norm_leaky's forward and backward kernels at NL_SHAPES,
    bf16, against their plain versions (within one bf16 ulp: the f32
    statistics sum in another order), timed beside the memory bound and
    F.instance_norm + F.leaky_relu; then the launches of one forward and
    backward of the s2d entry point under autograd."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf = torch.bfloat16
    summary = {"instance_norm_leaky_fwd": new_summary(),
               "instance_norm_leaky_bwd": new_summary()}
    for label, shape in NL_SHAPES:
        x = (1.5 * torch.randn(shape, generator=gen, device="cuda") + 0.3).to(bf)
        g = torch.randn(shape, generator=gen, device="cuda").to(bf)
        y, rstd = norm_leaky._norm_leaky_fwd(x)
        calls = {
            "instance_norm_leaky_fwd": (lambda: norm_leaky._norm_leaky_fwd(x)[0],
                                        lambda: norm_leaky.instance_norm_leaky_plain(x)[0], 2),
            "instance_norm_leaky_bwd": (lambda: norm_leaky._norm_leaky_bwd(g, y, rstd),
                                        lambda: norm_leaky.instance_norm_leaky_bwd_plain(
                                            g, y, rstd), 3),
        }
        xr = x.detach().requires_grad_(True)
        lib_y = F.leaky_relu(F.instance_norm(xr.transpose(1, 2)), 0.01)
        library = {"instance_norm_leaky_fwd": lambda: F.leaky_relu(
                       F.instance_norm(x.transpose(1, 2)), 0.01),
                   "instance_norm_leaky_bwd": lambda: torch.autograd.grad(
                       lib_y, xr, g.transpose(1, 2), retain_graph=True)[0]}
        for name, (kernel, plain, moved) in calls.items():
            got, ref = kernel(), plain()
            torch.cuda.synchronize()
            d = (got.float() - ref.float()).abs()
            if not bool((d <= bf16_ulp(ref) + 1e-6).all()) or not torch.isfinite(got.float()).all():
                raise AssertionError(f"{name} {label}: kernel disagrees with its plain version "
                                     f"(max |d| {float(d.max())})")
            b_ms, b_by = least_ms(moved * x.numel() * x.element_size(), 8 * x.numel())
            line = {"kernel": name, "block": label, "shape": list(shape),
                    "design": norm_leaky.design(shape[2], x.element_size(), True,
                                                bwd="bwd" in name),
                    "ms": cuda_ms(kernel), "bound_ms": b_ms, "bound_by": b_by,
                    "copy_ms": copy_ms(moved * x.numel() * x.element_size()),
                    "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library[name]),
                    "library": "F.instance_norm then F.leaky_relu, two calls on the (B, C, S) "
                               "view" + ("; autograd through them" if "bwd" in name else ""),
                    "max_abs_diff": float(d.max()),
                    "frac_elements_differing": float((d > 0).float().mean())}
            line["x_bound"] = line["ms"] / b_ms
            emit(line)
            add_call(summary[name], line)
            del got, ref, d
        del x, g, y, rstd, xr, lib_y
        torch.cuda.empty_cache()
    # the entry point: the s2d wrapper under autograd at ec3's output
    x = torch.randn((BATCH, 64, 64, 64, 256), generator=gen, device="cuda").to(bf)
    x.requires_grad_(True)
    reset_launch_counts()
    norm_leaky.instance_norm_leaky_s2d(x).float().square().sum().backward()
    torch.cuda.synchronize()
    launches = dict(launch_counts)
    if launches != counts(instance_norm_leaky_fwd=1, instance_norm_leaky_bwd=1):
        raise AssertionError(f"instance_norm_leaky_s2d forward + backward launched {launches}")
    if not torch.isfinite(x.grad.float()).all():
        raise AssertionError("non-finite instance_norm_leaky_s2d gradient")
    del x
    torch.cuda.empty_cache()
    return summary, launches


def train_parity_phase():
    """One float32 stage-1 train step on the card (kernels) against the
    same step on the CPU (plain versions): same weights, batch and
    DropLayer draws."""
    cfg = SEUNetConfig()
    tree = SEUNet(cfg, generator=torch.Generator().manual_seed(3)).params_tree()
    gen = torch.Generator().manual_seed(4)
    b, s = 2, 64
    batch = {"image": torch.rand((b, s, s, s, 2), generator=gen),
             "label": (torch.rand((b, s, s, s), generator=gen) > 0.7).float()}
    draws = [torch.rand((b, 24), generator=gen), torch.rand((b, 12), generator=gen)]
    opt, _ = make_optimizer()
    step = make_train_step(cfg, stage=1)
    out = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(_tree_map(lambda t: t.to(dev), tree), opt)
        reset_launch_counts()
        t0 = time.perf_counter()
        state, aux = step(state, {k: v.to(dev) for k, v in batch.items()}, drop_draws=draws)
        loss = float(aux["loss"])
        secs = time.perf_counter() - t0
        grads = [torch.zeros(t.shape) if t.grad is None else t.grad.cpu()
                 for t in _leaves(state.params)]
        params = [t.detach().cpu() for t in _leaves(state.params)]
        out[dev] = (loss, grads, params, dict(launch_counts), secs)
    (l_gpu, g_gpu, p_gpu, n_gpu, s_gpu), (l_cpu, g_cpu, p_cpu, n_cpu, s_cpu) = \
        out["cuda"], out["cpu"]
    if n_gpu != STEP_LAUNCHES or any(n_cpu.values()):
        raise AssertionError(f"f32 train step launched {n_gpu} on the card, {n_cpu} on the CPU")
    # the dice loss averages over every voxel, so a gradient element is
    # far below the atol: each leaf is also held against its own norm,
    # |d|_2 <= 2e-2 |g_cpu|_2 + floor, the floor for the conv biases in
    # front of an InstanceNorm, whose gradient is zero up to rounding
    floor = 1e-6 * max(float(r.norm()) for r in g_cpu)
    ratios = [float((a - r).norm() / r.norm()) for a, r in zip(g_gpu, g_cpu)
              if float(r.norm()) > floor]
    emit({"train_parity": {
        "crop": s, "batch": b, "dtype": "float32", "stage": 1, "launches_gpu": n_gpu,
        "loss_gpu": l_gpu, "loss_cpu": l_cpu,
        "grad_max_abs_diff": max(float((a - r).abs().max()) for a, r in zip(g_gpu, g_cpu)),
        "grad_leaf_norm_ratio_max": max(ratios),
        "grad_leaf_max_abs_min": min(float(r.abs().max()) for r in g_cpu
                                     if float(r.norm()) > floor),
        "grad_leaves": len(g_cpu), "grad_leaves_zero_up_to_rounding": len(g_cpu) - len(ratios),
        "param_max_abs_diff": max(float((a - r).abs().max()) for a, r in zip(p_gpu, p_cpu)),
        "step_s_gpu_first": s_gpu, "step_s_cpu": s_cpu}})
    torch.testing.assert_close(torch.tensor(l_gpu), torch.tensor(l_cpu), rtol=5e-3, atol=5e-4)
    for a, r in zip(g_gpu, g_cpu):
        torch.testing.assert_close(a, r, rtol=5e-3, atol=5e-4)
        if not float((a - r).norm()) <= 2e-2 * float(r.norm()) + floor:
            raise AssertionError(f"a gradient leaf {tuple(r.shape)} differs by "
                                 f"{float((a - r).norm())} against its norm {float(r.norm())}")


def train_path_phase(vol: np.ndarray, lumen: torch.Tensor):
    """make_train_step(stage=1) at full width, bf16, AdamW, on 8 crops of
    128^3 of the phantom: one warm-up step, TRAIN_STEPS timed steps."""
    cfg = SEUNetConfig(compute_dtype=torch.bfloat16)
    tree = SEUNet(cfg, generator=torch.Generator().manual_seed(0)).cuda().params_tree()
    opt, _ = make_optimizer()
    state = create_train_state(tree, opt)
    del tree
    # 8 crops along the trachea and the two main bronchi
    origins = [(z, 64, x) for z in (0, 64, 128, 192) for x in (48, 144)]
    hu = torch.from_numpy(vol).cuda()
    crop = [(slice(z, z + 128), slice(y, y + 128), slice(x, x + 128)) for z, y, x in origins]
    batch = {"image": hu_dual_window(torch.stack([hu[c] for c in crop]).float() - 1024.0),
             "label": torch.stack([lumen[c] for c in crop]).float()}
    del hu
    gen = torch.Generator(device="cuda").manual_seed(6)
    fixed = [torch.rand((BATCH, 24), generator=gen, device="cuda"),
             torch.rand((BATCH, 12), generator=gen, device="cuda")]
    loss_fn = make_loss_fn(cfg, stage=1)

    def fixed_loss() -> float:
        with torch.no_grad():
            return float(loss_fn(state.params, batch, drop_draws=fixed)[0])

    step = make_train_step(cfg, stage=1)
    loss_before = fixed_loss()

    # warm-up step; record the train kernels' calls to hold the train
    # kernel phase's shape table against what the step really runs
    seen = []
    orig_norm, orig_pool = eps.phased_normalize, ps2d.max_pool_s2d_bwd

    def norm_rec(y_ext, scale8, shift8):
        seen.append(("phased_normalize", y_ext.shape[1] - 1, y_ext.shape[-1]))
        return orig_norm(y_ext, scale8, shift8)

    def pool_rec(x, g=None):
        seen.append(("max_pool_s2d_bwd", x.shape[1], x.shape[-1]))
        return orig_pool(x, g)

    eps.phased_normalize, ps2d.max_pool_s2d_bwd = norm_rec, pool_rec
    try:
        t0 = time.perf_counter()
        state, aux = step(state, batch, gen)
        losses = [float(aux["loss"])]
        warm_s = time.perf_counter() - t0
    finally:
        eps.phased_normalize, ps2d.max_pool_s2d_bwd = orig_norm, orig_pool
    want = [("phased_normalize", n, c8) for _, n, c8, _ in PHASED] + \
        [("max_pool_s2d_bwd", n, c8) for _, n, c8 in POOLS]
    if sorted(seen) != sorted(want):
        raise AssertionError(f"the train step's kernel calls {sorted(seen)} differ from the "
                             f"train kernel phase's shape table")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, aux = step(state, batch, gen)
        losses.append(float(aux["loss"]))
        step_s.append(time.perf_counter() - t0)
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    loss_after = fixed_loss()
    if launches != {k: v * TRAIN_STEPS for k, v in STEP_LAUNCHES.items()}:
        raise AssertionError(f"train path launches {launches}, want {STEP_LAUNCHES} per step")
    if not all(np.isfinite(losses)) or not np.isfinite(loss_after):
        raise AssertionError(f"non-finite train loss: {losses}, {loss_after}")
    if not loss_after < loss_before:
        raise AssertionError(f"the batch's loss did not fall: {loss_before} -> {loss_after}")
    med = statistics.median(step_s[-5:])
    emit({"train_path": {
        "crop": 128, "batch": BATCH, "dtype": "bfloat16", "stage": 1, "remat": cfg.remat,
        "optimizer": "AdamW", "steps": TRAIN_STEPS, "warmup_s": warm_s, "step_s_runs": step_s,
        "step_s": med, "patches_per_s": BATCH / med, "peak_mem_gb": peak,
        "losses": losses, "fixed_draw_loss_before": loss_before,
        "fixed_draw_loss_after": loss_after, "launches": launches,
        "label_share": float(batch["label"].mean())}})
    return launches


class StepClock:
    """Seconds by step of an entry point: `patch` wraps module attributes
    (the functions the entry point calls) in host timers; a step marked
    `sync` waits for the card before its clock stops."""

    def __init__(self):
        self.s = defaultdict(float)
        self.stack = contextlib.ExitStack()

    def patch(self, owner, name: str, step: str, sync: bool = False) -> None:
        fn = getattr(owner, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            self.s[step] += time.perf_counter() - t0
            return out

        self.stack.enter_context(mock.patch.object(owner, name, timed))


def tile_batches(shape, cube: int, step: int) -> int:
    """Tile batches of the engine's runner (batch 1) over a volume."""
    return len(tile_positions(tuple(int(d) for d in np.maximum(shape, cube)), cube, step))


def on_mask(fn, mask: np.ndarray, at: int):
    """`fn` with its positional argument `at` replaced by `mask`, which
    must have the shape of the argument it replaces."""
    def call(*args, **kw):
        if args[at].shape != mask.shape:
            raise AssertionError(f"mask {args[at].shape}, substitute {mask.shape}")
        return fn(*args[:at], mask, *args[at + 1:], **kw)
    return call


def deployment_phase(vol: np.ndarray, lumen: torch.Tensor, params, cfg, tmp: str) -> None:
    """`network_prediction` on the phantom as a raw-HU NIfTI, eval mode,
    cli.predict's defaults (cube 128, step 64, the runner's batch 1):
    seconds by step, the K1/K2 launches (10 and 5 per tile batch), the
    route of the host library, the mask's voxel count. Random weights
    give a nearly solid mask, which no airway looks like: the skeleton
    and STL step is handed the phantom's airway lumen in the mask's frame
    instead, so its seconds are those of an airway-sized mask."""
    ct = os.path.join(tmp, "ct", "CASE_phantomdata.nii.gz")
    os.makedirs(os.path.dirname(ct))
    write_nifti(ct, (vol.astype(np.int32) - 1024).astype(np.int16))
    # the lumen through the same axis canonicalization as the CT
    lumen_nii = os.path.join(tmp, "ct", "lumen.nii.gz")
    write_nifti(lumen_nii, lumen.cpu().numpy().astype(np.uint8))
    airway = load_canonical(lumen_nii)[0]
    t0 = time.perf_counter()
    native = post.native_available()  # builds the host library at first use
    native_s = time.perf_counter() - t0
    clock = StepClock()
    for owner, name, at in ((post, "skeletonize_3d", 0), (post_mesh, "export_mask_stl", 1)):
        clock.stack.enter_context(mock.patch.object(
            owner, name, on_mask(getattr(owner, name), airway, at)))
    for owner, name, step, sync in (
            (engine, "preprocess_ct_volume", "preprocess", False),
            (SlidingWindowRunner, "predict_trits_summary_device", "device", True),
            (psw, "fetch_trits", "decode", False),
            (engine, "dti_fn", "dti", False),
            (engine, "border_suppress", "border_maximum_3d", False),
            (engine, "maximum_3d", "border_maximum_3d", False),
            (engine, "write_nifti", "write", False),
            (post, "skeletonize_3d", "stl", False),
            (post_mesh, "export_mask_stl", "stl", False)):
        clock.patch(owner, name, step, sync)
    torch.cuda.synchronize()
    reset_launch_counts()
    with clock.stack:
        t0 = time.perf_counter()
        out = engine.network_prediction(params, cfg, ct, os.path.join(tmp, "pred"))
        total_s = time.perf_counter() - t0
    launches = dict(launch_counts)
    img = read_nifti(os.path.join(tmp, "pred", "CASE_phantomdata_cut.nii.gz"))
    n = tile_batches(img.array.shape, 128, 64)
    if launches != counts(gathered_epilogue=10 * n, phased_epilogue=5 * n):
        raise AssertionError(f"deployment launches {launches}, want 10 and 5 per tile batch "
                             f"over {n}")
    mask = read_nifti(out).array
    if mask.shape != img.array.shape or mask.dtype != np.uint8 or mask.max() > 1:
        raise AssertionError(f"bad mask {mask.shape} {mask.dtype}")
    stl = os.path.join(tmp, "pred", "CASE_phantom_seg.stl")
    if native and mask.any() and not (os.path.exists(stl) and os.path.getsize(stl) > 84):
        raise AssertionError("no STL written with the native library present")
    line = {"shape": list(img.array.shape), "cube": 128, "step": 64, "batch": 1,
            "dtype": "bfloat16", "tile_batches": n, "seconds": dict(clock.s),
            "total_s": total_s, "launches": launches, "native_post": native,
            "native_build_s": native_s, "mask_voxels": int(mask.sum()),
            "stl_mask": "the phantom's airway lumen", "stl_mask_voxels": int(airway.sum()),
            "stl_bytes": os.path.getsize(stl) if os.path.exists(stl) else None}
    if not native:
        line["stl"] = "skipped: the native post-processing library did not build"
    emit({"engine_deployment": line})


def batch1_kernel_phase() -> None:
    """K1/K2 at the 15 epilogue call shapes of the engine's batch 1: the
    design `pick_design` takes, and the kernel against its plain version
    with phase 3's check (one bf16 ulp where no gate rounds; the gated
    products within four)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    lines = []
    for kind, table in EPILOGUE_TABLES.items():
        kernel, plain = getattr(eps, kind), getattr(eps, kind + "_plain")
        for block, n, c8, gates in table:
            y, scale8, shift8, wse = kernel_inputs(kind, n, c8, gates, gen, batch=1)
            got = kernel(y, scale8, shift8, wse)
            ref = plain(y, scale8, shift8, wse)
            err, ok = bf16_mismatch(got, ref)
            d = (got.float() - ref.float()).abs()
            one_ulp = bool((d <= bf16_ulp(ref)).all())
            if not ok or (not gates and not one_ulp) or not torch.isfinite(got.float()).all():
                raise AssertionError(f"{kind} {block} at batch 1: kernel disagrees with its "
                                     f"plain version (max |d| {err})")
            lines.append({"kernel": kind, "block": block, "shape": list(y.shape),
                          "gates": gates, "design": eps.pick_design(y, kind == "phased_epilogue"),
                          "max_abs_diff": err, "within_one_ulp": one_ulp,
                          "share_beyond_one_ulp": float((d > bf16_ulp(ref)).float().mean()),
                          "ms": cuda_ms(lambda: kernel(y, scale8, shift8, wse))})
            del y, got, ref, d
    emit({"engine_batch1_kernels": lines})


def card_cpu_phase(vol: np.ndarray, params, tmp: str) -> None:
    """`network_prediction` in float32 on a 64^3 crop of the phantom,
    cube 32, step 16, on the card and on the CPU: trit fields and masks
    equal except where the CPU's averaged score lies within 1e-5 of a
    threshold."""
    ct = os.path.join(tmp, "ct64", "CASE_cropdata.nii.gz")
    os.makedirs(os.path.dirname(ct))
    write_nifti(ct, (vol[CMP_CROP].astype(np.int32) - 1024).astype(np.int16))
    cfg = SEUNetConfig()
    fetch = psw.fetch_trits
    res = {}
    for dev in ("cuda", "cpu"):
        seen = []

        def keep(out):
            seen.append(fetch(out))
            return seen[-1]

        with mock.patch.object(psw, "fetch_trits", keep):
            path = engine.network_prediction(params, cfg, ct, os.path.join(tmp, "cmp_" + dev),
                                             cube=32, step=16, device=dev)
        res[dev] = (seen[0], read_nifti(path).array)
    img = read_nifti(os.path.join(tmp, "cmp_cpu", "CASE_cropdata_cut.nii.gz"))
    with torch.inference_mode():
        avg = SlidingWindowRunner(params, cfg, cube=32, step=16, device="cpu").predict_hu(
            img.array, hu_shift=-1024.0)
    near = (np.abs(avg - 0.5) < 1e-5) | (np.abs(avg - 0.4) < 1e-5)
    (t_card, m_card), (t_cpu, m_cpu) = res["cuda"], res["cpu"]
    line = {"shape": list(img.array.shape), "cube": 32, "step": 16, "dtype": "float32",
            "near_threshold_voxels": int(near.sum()),
            "trits_differing": int((t_card != t_cpu).sum()),
            "mask_voxels_differing": int((m_card != m_cpu).sum()),
            "mask_voxels": int(m_cpu.sum())}
    emit({"engine_card_vs_cpu": line})
    if (t_card != t_cpu)[~near].any() or (m_card != m_cpu)[~near].any():
        raise AssertionError("card and CPU network_prediction differ away from a threshold")


def write_cases(vol: np.ndarray, lumen: torch.Tensor, branch: np.ndarray, root: str):
    """The ENGINE_CASES crops as an AFTER_DATA tree with their priors: the
    port's skeleton of the lumen, the segment map as the branch parse,
    the upper half of the lumen as the stage-1 prediction."""
    lum = lumen.cpu().numpy()
    data_root, file_root = os.path.join(root, "AFTER_DATA"), os.path.join(root, "data")
    for name, org in ENGINE_CASES.items():
        sl = tuple(slice(o, o + ENGINE_CUT) for o in org)
        mask = lum[sl].astype(np.uint8)
        skel = post.skeletonize_3d(mask)
        files = {("AFTER_DATA", "data", name + "data_cut.nii.gz"): vol[sl],
                 ("AFTER_DATA", "mask", name + "mask_cut.nii.gz"): mask,
                 ("data", "pred_1", name + ".nii.gz"): mask * (np.arange(ENGINE_CUT) <
                                                               ENGINE_CUT // 2)[:, None, None]}
        for suffix in ("_test", "_val"):
            files[("data", "tree_parse" + suffix, name + "mask_cut.nii.gz")] = branch[sl]
            files[("data", "skeleton" + suffix, name + "mask_cut.nii.gz")] = skel
        for parts, arr in files.items():
            path = os.path.join(root, *parts)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_nifti(path, arr)
    return data_root, file_root


def dispatch_clock(records: list):
    """Patches of the engine that time each case with dispatch-ahead left
    as it is: the host seconds of its dispatch (upload and queueing), its
    device seconds between CUDA events recorded around that dispatch
    (upload through the codec), its host seconds from its results being
    ready to its metric block, and whether the next case's device work
    was still running when that host work began."""
    stack = contextlib.ExitStack()
    dispatch, finish, evaluate = (engine._dispatch_binarize, engine._finish_binarize,
                                  engine.evaluation_case)
    by_handle, current = {}, {}

    def timed_dispatch(*args, **kw):
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        handle = dispatch(*args, **kw)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        rec = {"start": start, "end": end, "dispatch_s": time.perf_counter() - t0}
        records.append(rec)
        by_handle[id(handle)] = rec
        return handle

    def timed_finish(handle):
        rec = by_handle.pop(id(handle))
        rec["end"].synchronize()
        rec["t0"] = time.perf_counter()
        later = records[records.index(rec) + 1:]
        rec["next_busy"] = bool(later) and not later[0]["end"].query()
        current["rec"] = rec
        return finish(handle)

    def timed_evaluate(*args, **kw):
        out = evaluate(*args, **kw)
        rec = current.pop("rec")
        rec["host_s"] = time.perf_counter() - rec["t0"]
        return out

    for name, fn in (("_dispatch_binarize", timed_dispatch), ("_finish_binarize", timed_finish),
                     ("evaluation_case", timed_evaluate)):
        stack.enter_context(mock.patch.object(engine, name, fn))
    return stack


def case_times(records: list, wall_s: float) -> dict:
    device = [r["start"].elapsed_time(r["end"]) / 1e3 for r in records]
    host = [r["host_s"] for r in records]
    return {"wall_s": wall_s, "dispatch_s": [r["dispatch_s"] for r in records],
            "device_s": device, "host_s": host,
            "wall_below_device_plus_host": wall_s < sum(device) + sum(host),
            "next_case_busy_at_host_post": [r["next_busy"] for r in records[:-1]]}


def entry_points_phase(vol, lumen, branch, params, cfg, tmp: str) -> None:
    """`run_test`, then one `validate(stage=2)`, on the two 160^3 cases:
    train mode, a seeded CUDA generator, cube 128, step 64, batch 1,
    dispatch-ahead depth 1. Per case dispatch, device and host seconds,
    each call's wall seconds, the launches (10 and 5 per tile batch) and
    every metric finite."""
    root = os.path.join(tmp, "cases")
    data_root, file_root = write_cases(vol, lumen, branch, root)
    names = list(ENGINE_CASES)
    gen = torch.Generator(device="cuda").manual_seed(7)
    line = {"cases": names, "cut": ENGINE_CUT}
    torch.cuda.synchronize()
    reset_launch_counts()
    for entry in ("run_test", "validate"):
        records = []
        with dispatch_clock(records):
            t0 = time.perf_counter()
            if entry == "run_test":
                out = engine.run_test(params, cfg, names, data_root, file_root,
                                      os.path.join(root, "testlog.txt"),
                                      os.path.join(root, "test_result"), generator=gen)
                values = [v for m in out for v in m.values()]
            else:
                out = engine.validate(params, cfg, names, data_root, file_root, 0,
                                      os.path.join(root, "log.txt"), stage=2, generator=gen)
                values = list(out)
            wall_s = time.perf_counter() - t0
        line[entry] = {**case_times(records, wall_s), "result": out}
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{entry}: non-finite metric {out}")
    launches = dict(launch_counts)
    n = 2 * len(names) * tile_batches((ENGINE_CUT,) * 3, 128, 64)
    if launches != counts(gathered_epilogue=10 * n, phased_epilogue=5 * n):
        raise AssertionError(f"run_test + validate launches {launches}, want 10 and 5 per "
                             f"tile batch over {n}")
    line["launches"] = launches
    emit({"engine_test_validate": line})


def engine_path_phase(vol: np.ndarray, lumen: torch.Tensor, branch: np.ndarray) -> None:
    """The inference entry points at full width, bf16, the seed of phase
    6, in a temporary working directory (run_test's boxplot lands
    there)."""
    cfg, model = get_model(seed=0, compute_dtype=torch.bfloat16)
    params = model.params_tree()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        deployment_phase(vol, lumen, params, cfg, tmp)
        batch1_kernel_phase()
        card_cpu_phase(vol, params, tmp)
        entry_points_phase(vol, lumen, branch, params, cfg, tmp)
    torch.cuda.empty_cache()


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

    t0 = time.perf_counter()
    lib = build_kernels()
    ptxas = ptxas_report(lib.build_log)
    emit({"build": {
        "seconds": time.perf_counter() - t0, "library": lib.path.name,
        "nvcc_seconds": lib.build_seconds, "ptxas": ptxas,
        "conv_wgmma": {
            "dynamic_smem_bytes": {f"BN={bn}": lib.lib.airseg_conv_wgmma_smem(bn)
                                   for bn in (64, 128, 256)},
            "ptxas": wgmma_report(ptxas)},
        "dil2_wgmma": {
            "dynamic_smem_bytes": {
                block: lib.lib.airseg_dil2_wgmma_smem(ci, *pcs.dil2_tile(ci, co)[:4])
                for block, _, ci, co in CS_DIL2}},
        "epilogue": {
            "tma_dynamic_smem_bytes": {f"phased 8C={c8}": lib.lib.airseg_epilogue_tma_smem(2, c8)
                                       for c8 in (128, 256, 512)},
            "ptxas": named_report(ptxas, ("epilogue_kernel", "persistent_ldg_kernel",
                                          "persistent_tma_kernel"))},
        "norm_leaky": {
            "ring_dynamic_smem_bytes": {d: lib.lib.airseg_norm_leaky_ring_smem()
                                        for d in ("fwd", "bwd")},
            "ring_stages": {d: norm_leaky.ring_stages(d == "bwd") for d in ("fwd", "bwd")},
            "ptxas": named_report(ptxas, ("ring_kernel", "reg_kernel"))}}})

    summary = kernel_phase()
    summary.update(train_kernel_phase())
    summary.update(conv_stats_kernel_phase())
    summary.update(conv_epi_kernel_phase())
    nl_summary, nl_launches = norm_leaky_phase()
    summary.update(nl_summary)
    model_parity_phase()
    config_parity_phase("conv_stats", SEUNetConfig(conv_stats=True), CS_LAUNCHES)
    config_parity_phase("conv_epi", SEUNetConfig(conv_epi=True), CE_LAUNCHES)
    vol, lumen, branch = phantom(0)
    main_launches, trits = main_path_phase(vol)
    cs_launches = config_path_phase("conv_stats", vol, trits, CS_VOLUMES, CS_LAUNCHES,
                                    conv_stats=True)
    ce_launches = config_path_phase("conv_epi", vol, trits, CE_VOLUMES, CE_LAUNCHES,
                                    conv_epi=True)
    train_parity_phase()
    train_launches = train_path_phase(vol, lumen)
    engine_path_phase(vol, lumen, branch)
    # each kernel's launches from the path that runs it
    launches = {**{k: main_launches[k] for k in EPILOGUE_TABLES},
                **{k: train_launches[k] for k in ("phased_normalize", "max_pool_s2d_bwd")},
                **{k: cs_launches[k] for k in ("phased_conv_stats", "dil2_conv_stats")},
                **{k: ce_launches[k] for k in ("dil2_dense_conv_stats", "phased_conv_ungathered")},
                **{k: nl_launches[k] for k in ("instance_norm_leaky_fwd",
                                                "instance_norm_leaky_bwd")}}

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][1],
         "replaces": KERNELS[name][0], "launches": launches[name],
         "max_abs_err": agg["max_abs_err"], "ms": agg["ms"], "plain_ms": agg["plain_ms"],
         "bound_ms": agg["bound_ms"], "bound_by": agg["bound_by"],
         "library_ms": agg["library_ms"],
         **{k: agg[k] for k in ("design", "copy_ms") if k in agg}}
        for name, agg in summary.items()]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
