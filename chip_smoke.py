#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (se_unet_airseg_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them. Phases:

1. device: the card's name and power limit (nvidia-smi); TF32 off for
   the float32 phases; `utils.device_summary()` and
   `utils.pick_devices(1, 40.0)` (`devices`);
2. build: nvcc builds the kernels from the seven sources under csrc/,
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
   the card's practical floor) and the `design` the wrapper picks by
   shape (persistent 16-byte loads or, for the phased forms, TMA);
4. train kernels: `phased_normalize` at the 5 phased shapes (with
   `design` and `copy_ms` as in phase 3) and the fused pool
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
8a. config train path: the stage-1 step under `conv_stats` and under
   `conv_epi`. One float32 step of 16^3 crops, batch 2, on the card
   against the CPU, same weights and DropLayer draws: the loss within
   rtol 5e-3, each gradient leaf within 2e-2 of its norm, the launches
   (K1/K8/K9/K6 7/5/3/2; K1/K2/K5/K10/K11/K6 10/5/5/3/5/2), as phase 7
   does for the default configuration. Then `make_resilient_step` at
   full width, bf16, remat off, on phase 8's crops, with cuDNN's default
   TF32 (as `cli.train` runs): a warm-up, CT_STEPS timed steps (median of
   the last 5); peak memory, the launches a step, every loss (falling
   from the first to the last, and under one fixed set of draws), whether
   the out-of-memory fallback engaged (`config_train_path`);
8b. remat step: one step of phase 8's configuration with
   `SEUNetConfig(remat=True)` against the same step with remat off (the
   same weights, batch and DropLayer draws, each from a fresh AdamW
   state): the loss within bf16 rounding, each gradient leaf within 2e-2
   of its norm, launches 20/5/5/2 against 10/5/5/2 (remat recomputes the
   gathered blocks in the backward), the peak memory of each;
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
9b. drivers path: `phased_normalize` and the pool backward at the batch-1
   shapes of the online hard-mining replay, checked and timed as in phase
   4 (`drivers_batch1_kernels`); then the curriculum drivers
   (`train/stages.py`) at full width, bf16, cube 128, batch 8, from the
   weights of phase 6, on the two 160^3 cases with every training prior
   (the port's LIB weights and skeletons, stage-3 break priors cut into
   the lumen by hand): `train_stage1` for 2 epochs, `train_stage2` and
   `train_stage3` for 1 each (online cache, batch-1 replay, validation),
   then `train_stage1` for 3 epochs on stage 1's directory, which must
   resume at epoch 2 from the saved step and AdamW moments. Per stage the
   main and replay steps, seconds by part (Prefetcher wait, B=8 steps,
   cache writes, replay, validation, checkpoints), the median B=8 step
   against phase 8's, peak memory; every loss finite, every step's
   launches 10/5/5/2 (the B=1 replay steps too), every validation's 10/5
   per tile batch, the files each run writes (`drivers_path`);
9c. curriculum path: the whole 3-stage curriculum through its entry
   point, `cli.train.main`, at full width, bf16, cube 128, batch 8, one
   epoch per stage, remat at the CLI's default (on), on the two 160^3
   cases, in a directory that holds only the raw data, the masks and
   base_dict.json: the port's priors (LIB weights, skeletons and parses
   of train and val), then stage 1 -> pred_1 -> stage 2 -> pred_2 ->
   save_weight_break -> stage 3 -> the DTI re-validations of stages 2
   and 3. Seconds by part, per stage what `drivers_path` reports, peak
   memory per stage, the voxels of pred_1 / pred_2, the break skeleton's
   points; every loss finite, every step's launches 20/5/5/2 (remat runs
   the 10 gathered blocks again in the backward; the B=1 replay steps
   too), every validation and prediction 10/5 per tile batch, the
   on-disk contract of tests/test_full_curriculum.py with `.pt` files.
   Then `save_weight_break` alone on write_cases' hand-broken pred_2:
   the break skeleton must hold every skeleton voxel of the gap and the
   weight be finite and non-zero there (`curriculum_path`);
9d. tree parsing: `cli.tree_parsing.main` with both parsers on the
   phantom's airway lumen (320x256x320): seconds by stage, both branch
   counts, which optional renders were written (they need matplotlib);
   each parse map covers every lumen voxel, every artifact that is not a
   render exists (`tree_parsing`);
9e. data parallel path: the mesh's `data` axis (`parallel/mesh.py`).
   NCCL takes one rank a card, so first one rank on NCCL (`env://` on
   127.0.0.1): the sharded stage-1 step at 128^3, batch 8, bf16, against
   the unsharded step on the same batch and draws with cuDNN's
   deterministic algorithms (loss within rtol 1e-6, each gradient leaf
   within 1e-6 of its norm beyond the unsharded step's own run-to-run
   spread, launches 10/5/5/2); the runner on that mesh over the phantom
   (batch 8 on the one rank, bf16): one `all_gather_into_tensor` on NCCL
   a tile batch (counted), launches 10/5 a tile batch, its trits equal to
   main_path's. Then two ranks sharing the card over gloo
   (spawned; their times are not a scaling figure): three f32 stage-1
   steps at 32^3, global batch 4, 1 (replicated), 4 (the first against
   one process, both with cuDNN's deterministic algorithms: the loss
   within DP_F32_LOSS_RTOL, each gradient leaf within DP_F32_LEAF_RTOL of
   its norm from one process forming the loss from the ranks' row blocks
   and within DP_F32_BATCH_LEAF_RTOL from the B=4 step; after the three
   the ranks' parameters and AdamW moments bitwise equal); the
   stage-1 step at 128^3, global batch 8 (4 a rank), bf16: per rank the
   median of DP_STEPS steps after a warm-up, the gradient all_reduce's
   seconds (DP_ALLREDUCE_STEPS more steps), peak memory, launches
   10/5/5/2 a step; the sharded runner (batch 8, 4 tiles a rank, bf16) on
   the phantom: seconds a volume, launches 10/5 a tile batch on each
   rank, the scores within DP_SCORE_ATOL of the one-process runner's, at
   most DP_TRIT_FRACTION of the trits different from main_path's;
   `train_stage2` for one epoch on the two 160^3 cuts (4 crops a rank):
   every step's launches, the losses and parameters equal on the ranks,
   the files written by rank 0 alone, the validation split by case
   (`data_parallel_path`);
9f. space path: the mesh's `space` axis (each crop's depth split over
   ranks). K1, K2 and K5 at the depth-slab shapes of 128^3 crops on 2
   space ranks, (8, 32, 64, 64, 8C) and (8, 16, 32, 32, 8C), the phased
   forms on their (nz+1)-plane window grids, against their plain versions
   with the kernel phase's checks (ms, design, bound). Then two ranks
   sharing the card over gloo as a (data 1, space 2) mesh (spawned; their
   times are not a scaling figure): the f32 stage-3 step at 32^3, global
   batch 2, depth split, against one process (cuDNN deterministic on both
   sides: the loss within SP_F32_LOSS_RTOL, the per-crop GUL, each
   gradient leaf within SP_F32_LEAF_RTOL of its norm; the ranks'
   parameters bitwise equal); the depth-split stage-1 step at 128^3,
   batch 8, bf16: per rank the median of SP_STEPS steps after a warm-up,
   peak memory (against train_path's), launches 10/5/5/2 a step, then one
   step with every halo exchange and statistics sum timed between two
   synchronizes (their count, bytes and seconds); the depth-split runner
   on the phantom (batch 8, 64 planes a rank): seconds a volume, launches
   10/5 a tile batch, the scores within SP_SCORE_ATOL of the one-process
   runner's, at most SP_TRIT_FRACTION of the trits different from
   main_path's (`space_path`);
9g. dry run: `entry.dryrun_multichip(4)`, 4 gloo ranks sharing the card
   as a (data 2, space 2) mesh (not a scaling figure): the f32 stage-3
   step of 16^3 crops and the runner (cube 32) against one process (the
   loss, each gradient leaf against its norm, the scores), then the f32
   eval forward of 2 crops of 128^3, each rank one crop's depth slab,
   gathered over space and data: finite, within 1e-4 of one process's,
   its seconds and each rank's peak memory; then the one-process half
   again with every K1/K2/K5/K6 launch held against its plain version on
   its float32 inputs and on a rank's part of them (half the crops, half
   the depth), the epilogues within 1e-6 + 1e-5 |plain|, the pool
   backward exactly (`dryrun_path`);
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
16a. norm_stats (K12): the statistics kernel in both forms at the 15
   blocks' shapes of a tile batch (batch 8, bf16: the 10 gathered
   outputs, the 5 phased conv outputs (B, n+1, n+1, n+1, 8C)), each
   against its plain version and the float64 sums (NS_RTOL), twice
   bitwise equal; with ms, the plain version's ms, the memory bound (the
   windows read once) and `copy_ms` (no one PyTorch call computes both
   sums). Every launch count above also holds K12's: 15 a tile batch, 30
   a train step, 40 with remat (7 and 14 under conv_stats, 12 and 27
   under conv_epi);
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
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from se_unet_airseg_tpu_torch import post
from se_unet_airseg_tpu_torch.cli import train as cli_train
from se_unet_airseg_tpu_torch.cli import tree_parsing as tp_cli
from se_unet_airseg_tpu_torch.data import tile_positions
from se_unet_airseg_tpu_torch.data.splits import load_json_file
from se_unet_airseg_tpu_torch.entry import FORWARD_ATOL, _dryrun, dryrun_multichip
from se_unet_airseg_tpu_torch.infer import SlidingWindowRunner, engine
from se_unet_airseg_tpu_torch.infer import sliding_window as psw
from se_unet_airseg_tpu_torch.io import read_nifti, write_nifti
from se_unet_airseg_tpu_torch.pipeline import orchestrate, priors
from se_unet_airseg_tpu_torch.pipeline.preprocess import load_canonical
from se_unet_airseg_tpu_torch.post import atm22 as post_atm22
from se_unet_airseg_tpu_torch.post import mesh as post_mesh
from se_unet_airseg_tpu_torch.post import topology as post_topology
from se_unet_airseg_tpu_torch.models import (
    SEUNet,
    SEUNetConfig,
    get_model,
    se_unet_apply,
    se_unet_apply_fast,
)
from se_unet_airseg_tpu_torch.models.se_unet import _DIL2_NG, _leaves, _tree_map, draw_dropout
from se_unet_airseg_tpu_torch.ops import build_kernels, conv3d, hu_dual_window, launch_counts
from se_unet_airseg_tpu_torch.ops import conv_stats as pcs
from se_unet_airseg_tpu_torch.ops import epilogue_s2d as eps
from se_unet_airseg_tpu_torch.ops import norm_leaky, reset_launch_counts
from se_unet_airseg_tpu_torch.ops import s2d as ps2d
from se_unet_airseg_tpu_torch.ops.lib_filter import lib_weight_map
from se_unet_airseg_tpu_torch.parallel import make_mesh, spawn
from se_unet_airseg_tpu_torch.train import (
    create_train_state,
    make_loss_fn,
    make_optimizer,
    make_resilient_step,
    make_train_step,
)
from se_unet_airseg_tpu_torch.train import stages
from se_unet_airseg_tpu_torch.train import step as pstep
from se_unet_airseg_tpu_torch.train.checkpoint import _paths
from se_unet_airseg_tpu_torch.utils import device_summary, pick_devices

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
    "norm_stats": ("none (the JAX package's statistics are XLA reductions)",
                   "se_unet_airseg_tpu_torch/csrc/norm_stats.cu"),
}
EPILOGUE_TABLES = {"gathered_epilogue": GATHERED, "phased_epilogue": PHASED}
# engine path: the 160^3 test / validation cases cut from the phantom
# (origins), and the 64^3 crop held card against CPU
ENGINE_CUT = 160
ENGINE_CASES = {"CASE_a": (48, 48, 80), "CASE_b": (160, 48, 40)}
CMP_CROP = (slice(96, 160), slice(96, 160), slice(128, 192))
DRIVER_CUBE = 128  # the drivers' crop and validation tile
# data_parallel_path: ranks sharing the card over gloo, timed steps and
# volumes, the f32 check's (global batch, crop) and its bounds against
# one process, cuDNN's deterministic algorithms on both sides: the loss,
# a gradient leaf against one process forming the loss from the ranks'
# row blocks (the sum over ranks alone), and against the B=4 step (the
# card rounds a 1x1x1 conv's gradient differently at B=2 and B=4); and
# the bounds on the sharded runner against one process (bf16: batch 4
# against 8 a forward, the per-tile route against the s2d-folded one):
# its scores, and the share of trits that differ from main_path's.
# PERF.md (§6) puts each bound beside the sound runs' largest reading
# and what planted faults read.
DP_RANKS = 2
DP_STEPS = 5
DP_ALLREDUCE_STEPS = 3
DP_VOLUMES = 3
DP_F32 = (4, 32)
DP_F32_LOSS_RTOL = 1e-6
DP_F32_LEAF_RTOL = 1e-6
DP_F32_BATCH_LEAF_RTOL = 1e-2
DP_SCORE_ATOL = 0.02
DP_TRIT_FRACTION = 1e-4
# space_path: the mesh's `space` axis, (data 1, space 2) over gloo with the
# two ranks sharing the card (not a scaling figure): the f32 check's
# (global batch, crop) and its bounds against one process (cuDNN's
# deterministic algorithms on both sides; the depth split adds each crop's
# statistics in another order, and a one-ulp change of the input moves a
# leaf of the CPU test's step by 6.5e-3, the split by up to 1.1e-2, while
# a wrong adjoint moves one by 0.87 or more: PERF.md §6), the timed
# full-width steps, and the eval forward's bounds against one process
# and main_path (as the data axis's).
SP_RANKS = 2
SP_STEPS = 3
SP_F32 = (2, 32)
SP_F32_LOSS_RTOL = 1e-5
SP_F32_LEAF_RTOL = 5e-2
SP_SCORE_ATOL = DP_SCORE_ATOL
SP_TRIT_FRACTION = DP_TRIT_FRACTION
# the one NCCL rank's runner runs main_path's batch of 8 on one rank:
# the same tiles through the same kernels, so its trits must equal
# main_path's
NCCL_TRIT_BOUND = 0
# config_train_path: the crop of the f32 check against the CPU (batch 2,
# train_parity's bounds); the timed bf16 128^3 B=8 steps after a warm-up
# (median of the last 5), under cuDNN's default TF32, as cli.train runs
CT_CROP = 16
CT_STEPS = 10
# dryrun_path: the epilogue kernels against their plain versions on the
# dry run's float32 inputs (tests/test_torch_cuda.py's float32 tolerance);
# the pool backward exactly
F32_EPI_ATOL, F32_EPI_RTOL = 1e-6, 1e-5
# norm_stats: f32 sums in another order than the plain version's; each
# within NS_RTOL of the float64 sum, relative to the lane's sum of |y|
# (s1) or to itself (s2): a thread adds up to ~500 rows in turn (worst
# case 500 * 2^-24 = 3e-5, random rounding ~ sqrt(500) * 2^-24 = 1.3e-6)
NS_RTOL = 1e-5


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


def infer_counts(n: int) -> dict:
    """The launches of n tile batches of the default forward: K1 and K2,
    each after K12's statistics of its block."""
    return counts(gathered_epilogue=10 * n, phased_epilogue=5 * n, norm_stats=15 * n)


# K12 (norm_stats) runs once for each block's statistics: before each K1
# and K2 of the forward (remat's replay too), and again in each gathered
# and phased block's backward, which recomputes them
STEP_LAUNCHES = counts(gathered_epilogue=10, phased_epilogue=5, phased_normalize=5,
                       max_pool_s2d_bwd=2, norm_stats=30)
CS_LAUNCHES = counts(gathered_epilogue=7, phased_conv_stats=5, dil2_conv_stats=3, norm_stats=7)
REMAT_LAUNCHES = counts(gathered_epilogue=20, phased_epilogue=5, phased_normalize=5,
                        max_pool_s2d_bwd=2, norm_stats=40)
# a train step under conv_stats: the forward's K8, K9 and K1 and the pool
# backward (the K8/K9 backward is autograd of their plain versions, the
# phased blocks take no K2/K5); under conv_epi: the forward's K10, K11, K1
# and K2, the phased backward's K5 (its replay runs cuDNN's conv, the
# dil-2 backward's too) and the pool backward. K12: the K1 blocks, whose
# sums K8/K9 do not make, forward and backward; under conv_epi the dil-2
# blocks' sums come from K10 in the forward and from K12 in the backward
CS_STEP_LAUNCHES = counts(gathered_epilogue=7, phased_conv_stats=5, dil2_conv_stats=3,
                          max_pool_s2d_bwd=2, norm_stats=14)
CE_STEP_LAUNCHES = counts(gathered_epilogue=10, phased_epilogue=5, phased_normalize=5,
                          dil2_dense_conv_stats=3, phased_conv_ungathered=5, max_pool_s2d_bwd=2,
                          norm_stats=27)
CE_LAUNCHES = counts(gathered_epilogue=10, phased_epilogue=5, dil2_dense_conv_stats=3,
                     phased_conv_ungathered=5, norm_stats=12)


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


def bound(elt: int, out_numel: int, c8: int, gates: int, batch: int = BATCH):
    """Least time for one epilogue call: the elements the output needs
    read once (one per output element: the phased form reads only its 8
    shifted n^3 windows of the (n+1)^3 conv output), scale8/shift8 and
    the gate vectors read once, the output written once (bytes), against
    about (4 + 4G) f32 operations per output element (affine, LeakyReLU,
    per gate a multiply-add and a multiply, the sigmoid once per C
    lanes)."""
    nbytes = (2 * out_numel + gates * c8 // 8) * elt + 2 * batch * c8 * 4
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
                    "max_abs_diff": err, "frac_elements_differing": frac}
            line["x_bound"] = ms / b_ms
            emit(line)
            add_call(agg, line)
            del y, got, ref
        summary[kind] = agg
    torch.cuda.empty_cache()
    return summary


def norm_stats_close(got: torch.Tensor, y: torch.Tensor, phased: bool) -> float:
    """The largest error of (2, B, 8C) sums against the float64 sums of y,
    over NS_RTOL times the lane's sum of |y| (s1) or its float64 sum of
    squares (s2): at most 1 where the sums hold."""
    exact = eps.norm_stats_plain(y.double(), phased)
    mag = torch.stack([eps.norm_stats_plain(y.double().abs(), phased)[0], exact[1]])
    return float(((got.double() - exact).abs() / (NS_RTOL * mag + 1e-30)).max())


def norm_stats_phase(batch: int = BATCH):
    """K12 at the 15 blocks' statistics shapes of a tile batch: the
    gathered outputs and the phased conv outputs, against the plain
    version and the float64 sums, twice bitwise equal."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    agg = new_summary()
    for phased, table in ((False, GATHERED), (True, PHASED)):
        for block, n, c8, _ in table:
            m = n + 1 if phased else n
            y = torch.randn((batch, m, m, m, c8), generator=gen, device="cuda")
            y = y.to(torch.bfloat16)
            got = eps.norm_stats(y, phased)
            again = eps.norm_stats(y, phased)
            ref = eps.norm_stats_plain(y, phased)
            err, plain_err = norm_stats_close(got, y, phased), norm_stats_close(ref, y, phased)
            if not torch.equal(got, again) or not err <= 1.0:
                raise AssertionError(f"norm_stats {block}: error {err} of NS_RTOL, or two "
                                     f"launches differ")
            nbytes = batch * n ** 3 * c8 * y.element_size()
            b_ms, b_by = least_ms(nbytes + 2 * batch * c8 * 4, 2 * batch * n ** 3 * c8)
            line = {"kernel": "norm_stats", "block": block, "shape": list(y.shape),
                    "form": "phased" if phased else "gathered",
                    "chunk_rows": eps.norm_stats_chunk(batch, eps.norm_stats_rows(y.shape, phased),
                                                       c8, y.element_size(),
                                                       eps._sm_count(y.device.index)),
                    "ms": cuda_ms(lambda: eps.norm_stats(y, phased)),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "plain_ms": cuda_ms(lambda: eps.norm_stats_plain(y, phased)),
                    "copy_ms": copy_ms(nbytes),
                    "max_abs_diff": float((got - ref).abs().max()),
                    "err_of_rtol": err, "plain_err_of_rtol": plain_err}
            line["x_bound"] = line["ms"] / b_ms
            emit(line)
            add_call(agg, line)
            del y, got, again, ref
    torch.cuda.empty_cache()
    return {"norm_stats": agg}


def pool_input(n: int, c8: int, gen: torch.Generator, batch: int = BATCH) -> torch.Tensor:
    """bf16 (B, n, n, n, 8C) pool input with ties among the 8
    sub-positions: on every third channel sub-positions 3 and 6 copy 1,
    on every seventh all 8 are equal."""
    x8 = torch.randn((batch, n, n, n, 8, c8 // 8), generator=gen, device="cuda")
    x8[..., 3, ::3] = x8[..., 1, ::3]
    x8[..., 6, ::3] = x8[..., 1, ::3]
    x8[..., :, ::7] = x8[..., :1, ::7]
    return x8.flatten(-2).to(torch.bfloat16)


def train_kernel_phase(batch: int = BATCH):
    """phased_normalize at the 5 phased shapes and the fused pool
    backward at the 2 pool shapes of one train step of `batch` crops
    (8: the train path; 1: the drivers' online hard-mining replay), each
    against its plain version (normalize within one bf16 ulp; pool exact,
    one ulp where a tie divides); the pool also against autograd of
    amax."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    summary = {"phased_normalize": new_summary(), "max_pool_s2d_bwd": new_summary()}
    for block, n, c8, _ in PHASED:
        y, scale8, shift8, _ = kernel_inputs("phased_epilogue", n, c8, 0, gen, batch=batch)
        got = eps.phased_normalize(y, scale8, shift8)
        ref = eps.phased_normalize_plain(y, scale8, shift8)
        d = (got.float() - ref.float()).abs()
        if not bool((d <= bf16_ulp(ref)).all()) or not torch.isfinite(got.float()).all():
            raise AssertionError(f"phased_normalize {block}: kernel disagrees with its "
                                 f"plain version (max |d| {float(d.max())})")
        b_ms, b_by = bound(y.element_size(), got.numel(), c8, 0, batch)
        line = {"kernel": "phased_normalize", "block": block, "shape": list(y.shape),
                "design": eps.pick_design(y, True),
                "ms": cuda_ms(lambda: eps.phased_normalize(y, scale8, shift8)),
                "bound_ms": b_ms, "bound_by": b_by,
                "plain_ms": cuda_ms(lambda: eps.phased_normalize_plain(y, scale8, shift8)),
                "copy_ms": copy_ms(2 * got.numel() * got.element_size()),
                "max_abs_diff": float(d.max()),
                "frac_elements_differing": float((d > 0).float().mean())}
        line["x_bound"] = line["ms"] / b_ms
        emit(line)
        add_call(summary["phased_normalize"], line)
        del y, got, ref, d
    for block, n, c8 in POOLS:
        x = pool_input(n, c8, gen, batch)
        g = torch.randn((batch, n, n, n, c8 // 8), generator=gen, device="cuda")
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
    if launched != infer_counts(1):
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
    if launches != infer_counts(n_batches):
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


def train_parity_phase(cfg: SEUNetConfig | None = None, crop: int = 64,
                       want: dict = STEP_LAUNCHES) -> dict:
    """One float32 stage-1 train step on the card (kernels) against the
    same step on the CPU (plain versions): same weights (seed 3), batch of
    2 crops of `crop`^3 and DropLayer draws (seed 4), under `cfg` (default:
    the default configuration); the card launches `want`, the CPU nothing.
    Emits its line and returns it."""
    cfg = cfg or SEUNetConfig()
    tree = SEUNet(cfg, generator=torch.Generator().manual_seed(3)).params_tree()
    gen = torch.Generator().manual_seed(4)
    b, s = 2, crop
    batch = {"image": torch.rand((b, s, s, s, 2), generator=gen),
             "label": (torch.rand((b, s, s, s), generator=gen) > 0.7).float()}
    draws = draw_dropout(b, cfg, gen)
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
    config = [k for k in ("conv_stats", "conv_epi") if getattr(cfg, k)] or ["default"]
    if n_gpu != want or any(n_cpu.values()):
        raise AssertionError(f"f32 {config[0]} train step launched {n_gpu} on the card, "
                             f"{n_cpu} on the CPU")
    # the dice loss averages over every voxel, so a gradient element is
    # far below the atol: each leaf is also held against its own norm,
    # |d|_2 <= 2e-2 |g_cpu|_2 + floor, the floor for the conv biases in
    # front of an InstanceNorm, whose gradient is zero up to rounding
    floor = 1e-6 * max(float(r.norm()) for r in g_cpu)
    ratios = [float((a - r).norm() / r.norm()) for a, r in zip(g_gpu, g_cpu)
              if float(r.norm()) > floor]
    line = {
        "config": config[0], "crop": s, "batch": b, "dtype": "float32", "stage": 1,
        "launches_gpu": n_gpu, "loss_gpu": l_gpu, "loss_cpu": l_cpu,
        "grad_max_abs_diff": max(float((a - r).abs().max()) for a, r in zip(g_gpu, g_cpu)),
        "grad_leaf_norm_ratio_max": max(ratios), "grad_worst_leaf": worst_leaf(g_gpu, g_cpu),
        "grad_leaf_max_abs_min": min(float(r.abs().max()) for r in g_cpu
                                     if float(r.norm()) > floor),
        "grad_leaves": len(g_cpu), "grad_leaves_zero_up_to_rounding": len(g_cpu) - len(ratios),
        "param_max_abs_diff": max(float((a - r).abs().max()) for a, r in zip(p_gpu, p_cpu)),
        "step_s_gpu_first": s_gpu, "step_s_cpu": s_cpu}
    emit({"train_parity": line})
    torch.testing.assert_close(torch.tensor(l_gpu), torch.tensor(l_cpu), rtol=5e-3, atol=5e-4)
    for a, r in zip(g_gpu, g_cpu):
        torch.testing.assert_close(a, r, rtol=5e-3, atol=5e-4)
        if not float((a - r).norm()) <= 2e-2 * float(r.norm()) + floor:
            raise AssertionError(f"a gradient leaf {tuple(r.shape)} differs by "
                                 f"{float((a - r).norm())} against its norm {float(r.norm())}")
    return line


def phantom_batch(vol: np.ndarray, lumen: torch.Tensor) -> dict:
    """The train path's batch: 8 crops of 128^3 of the phantom along the
    trachea and the two main bronchi (dual-windowed image, lumen label),
    on lumen's device."""
    origins = [(z, 64, x) for z in (0, 64, 128, 192) for x in (48, 144)]
    hu = torch.from_numpy(vol).to(lumen.device)
    crop = [(slice(z, z + 128), slice(y, y + 128), slice(x, x + 128)) for z, y, x in origins]
    return {"image": hu_dual_window(torch.stack([hu[c] for c in crop]).float() - 1024.0),
            "label": torch.stack([lumen[c] for c in crop]).float()}


def train_path_phase(vol: np.ndarray, lumen: torch.Tensor):
    """make_train_step(stage=1) at full width, bf16, AdamW, on 8 crops of
    128^3 of the phantom: one warm-up step, TRAIN_STEPS timed steps."""
    cfg = SEUNetConfig(compute_dtype=torch.bfloat16)
    tree = SEUNet(cfg, generator=torch.Generator().manual_seed(0)).cuda().params_tree()
    opt, _ = make_optimizer()
    state = create_train_state(tree, opt)
    del tree
    batch = phantom_batch(vol, lumen)
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
    return launches, med, batch, fixed, peak


def remat_phase(batch: dict, draws: list) -> None:
    """One full-width bf16 stage-1 step with SEUNetConfig(remat=True) held
    to the same step with remat off: the weights of train_path (seed 0),
    its batch and fixed DropLayer draws, each from a fresh AdamW state.
    The loss within bf16 rounding, each gradient leaf within 2e-2 of its
    own norm, the launches (remat recomputes the 10 gathered blocks in
    the backward: K1 20 per step), and the peak memory of each step."""
    out = {}
    for remat in (False, True):
        cfg = SEUNetConfig(compute_dtype=torch.bfloat16, remat=remat)
        tree = SEUNet(cfg, generator=torch.Generator().manual_seed(0)).cuda().params_tree()
        opt, _ = make_optimizer()
        state = create_train_state(tree, opt)
        del tree
        step = make_train_step(cfg, stage=1)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, aux = step(state, batch, drop_draws=draws)
        loss = float(aux["loss"])
        secs = time.perf_counter() - t0
        grads = [torch.zeros(t.shape) if t.grad is None else t.grad.float().cpu()
                 for t in _leaves(state.params)]
        out[remat] = {"loss": loss, "step_s_first": secs, "launches": dict(launch_counts),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "grads": grads}
        del state, step, aux
    off, on = out[False], out[True]
    floor = 1e-6 * max(float(r.norm()) for r in off["grads"])
    ratios = [float((a - r).norm() / r.norm()) for a, r in zip(on["grads"], off["grads"])
              if float(r.norm()) > floor]
    emit({"remat_step": {
        "crop": batch["label"].shape[1], "batch": batch["label"].shape[0], "dtype": "bfloat16",
        "stage": 1,
        **{f"{k}_{name}": v[k] for name, v in (("remat_off", off), ("remat_on", on))
           for k in ("loss", "step_s_first", "peak_mem_gb", "launches")},
        "loss_abs_diff": abs(on["loss"] - off["loss"]),
        "grad_leaf_norm_ratio_max": max(ratios)}})
    torch.cuda.empty_cache()
    if off["launches"] != STEP_LAUNCHES or on["launches"] != REMAT_LAUNCHES:
        raise AssertionError(f"remat step launches {on['launches']}, remat off "
                             f"{off['launches']}")
    if not (math.isfinite(on["loss"]) and abs(on["loss"] - off["loss"])
            <= 2.0 ** -7 * abs(off["loss"]) + 1e-3):
        raise AssertionError(f"remat step loss {on['loss']} against {off['loss']}")
    if not max(ratios) <= 2e-2:
        raise AssertionError(f"remat step gradients differ: leaf norm ratio {max(ratios)}")


def config_train_full(name: str, batch: dict) -> dict:
    """make_resilient_step(stage=1) under `name` at full width, bf16, remat
    off, AdamW, on train_path's 8 phantom crops of 128^3, with cuDNN's
    default TF32, as `cli.train` runs it (the script turns TF32 off for
    its f32 checks): a warm-up step, then CT_STEPS timed steps (median of
    the last 5). Peak memory over them, the launches per step, every
    step's loss and the loss under one fixed set of DropLayer draws
    before and after, and whether the out-of-memory fallback (remat)
    engaged."""
    cfg = SEUNetConfig(compute_dtype=torch.bfloat16, **{name: True})
    tree = SEUNet(cfg, generator=torch.Generator().manual_seed(0)).cuda().params_tree()
    state = create_train_state(tree, make_optimizer()[0])
    del tree
    gen = torch.Generator(device="cuda").manual_seed(6)
    fixed = draw_dropout(BATCH, cfg, torch.Generator(device="cuda").manual_seed(7))
    loss_fn = make_loss_fn(cfg, stage=1)

    def fixed_loss() -> float:
        with torch.no_grad():
            return float(loss_fn(state.params, batch, drop_draws=fixed)[0])

    step = make_resilient_step(cfg, stage=1)
    loss_before = fixed_loss()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=True):
        for i in range(1 + CT_STEPS):
            if i == 1:
                reset_launch_counts()
            t0 = time.perf_counter()
            state, aux = step(state, batch, gen)
            losses.append(float(aux["loss"]))
            step_s.append(time.perf_counter() - t0)
    launches = {k: v / CT_STEPS for k, v in launch_counts.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    loss_after = fixed_loss()
    fellback = step.fallback_active()
    med = statistics.median(step_s[-5:])
    out = {"crop": batch["label"].shape[1], "batch": batch["label"].shape[0],
           "dtype": "bfloat16", "stage": 1, "remat": cfg.remat, "optimizer": "AdamW",
           "cudnn_tf32": "default (on)", "steps": CT_STEPS, "warmup_s": step_s[0],
           "step_s_runs": step_s[1:], "step_s": med, "patches_per_s": BATCH / med,
           "peak_mem_gb": peak, "losses": losses, "fixed_draw_loss_before": loss_before,
           "fixed_draw_loss_after": loss_after, "launches_per_step": launches,
           "oom_fallback_engaged": fellback}
    del state, step
    torch.cuda.empty_cache()
    return out


def check_config_train(name: str, full: dict, want: dict) -> None:
    """Raise unless the bf16 steps under `name` launched `want` a step
    (remat's launches, if the fallback engaged, are printed, not pinned)
    and their losses are finite and fall, step and fixed draws alike."""
    if not full["oom_fallback_engaged"] and \
            full["launches_per_step"] != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"the bf16 {name} step launched {full['launches_per_step']} a "
                             f"step, want {want}")
    losses, before, after = (full["losses"], full["fixed_draw_loss_before"],
                             full["fixed_draw_loss_after"])
    if not all(np.isfinite(losses + [before, after])):
        raise AssertionError(f"non-finite {name} train loss: {losses}, {before}, {after}")
    if not (losses[-1] < losses[0] and after < before):
        raise AssertionError(f"the {name} loss did not fall: steps {losses[0]} -> "
                             f"{losses[-1]}, fixed draws {before} -> {after}")


def config_train_path_phase(batch: dict) -> None:
    """The stage-1 train step under conv_stats and under conv_epi: the f32
    step of 2 crops of CT_CROP^3, card against CPU (`train_parity_phase`,
    its bounds), then the full-size bf16 steps (`config_train_full`). The
    train step's launches of K8-K11 come from here."""
    line, wants = {}, {"conv_stats": CS_STEP_LAUNCHES, "conv_epi": CE_STEP_LAUNCHES}
    for name, want in wants.items():
        t0 = time.perf_counter()
        line[name] = {"f32_parity": train_parity_phase(SEUNetConfig(**{name: True}), CT_CROP,
                                                       want),
                      "full": config_train_full(name, batch),
                      "phase_wall_s": time.perf_counter() - t0}
    emit({"config_train_path": line})
    for name, want in wants.items():
        check_config_train(name, line[name]["full"], want)


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
    if launches != infer_counts(n):
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


def write_raw_cases(vol: np.ndarray, lumen: torch.Tensor, root: str):
    """The ENGINE_CASES crops as an AFTER_DATA tree (the CT as int16
    HU+1024, the lumen as the mask) and base_dict.json: both cases
    train, the first validates. Returns (data_root, file_root)."""
    lum = lumen.cpu().numpy()
    data_root, file_root = os.path.join(root, "AFTER_DATA"), os.path.join(root, "data")
    for name, org in ENGINE_CASES.items():
        sl = tuple(slice(o, o + ENGINE_CUT) for o in org)
        for sub, arr in (("data", vol[sl]), ("mask", lum[sl].astype(np.uint8))):
            os.makedirs(os.path.join(data_root, sub), exist_ok=True)
            write_nifti(os.path.join(data_root, sub, f"{name}{sub}_cut.nii.gz"), arr)
    names = list(ENGINE_CASES)
    os.makedirs(file_root, exist_ok=True)
    with open(os.path.join(file_root, "base_dict.json"), "w") as f:
        json.dump({"0": {"train": names, "val": names[:1]}}, f)
    return data_root, file_root


def write_cases(vol: np.ndarray, lumen: torch.Tensor, branch: np.ndarray, root: str):
    """`write_raw_cases` and every prior the entry points and the three
    training stages read: the port's skeleton of the lumen (train, val,
    test), the segment map as the branch parse, the upper half of the
    lumen as the stage-1 prediction, the port's LIB weights (float16),
    and stage-3 break priors made by hand: the lumen with a 4-slice axial
    gap at the middle of its extent as the stage-2 prediction, the
    skeleton's voxels in the gap as the break skeleton ((3, N)
    coordinates), the lumen within 4 slices of the gap as the break
    weight (float16)."""
    data_root, file_root = write_raw_cases(vol, lumen, root)
    lum = lumen.cpu().numpy()
    for name, org in ENGINE_CASES.items():
        sl = tuple(slice(o, o + ENGINE_CUT) for o in org)
        mask = lum[sl].astype(np.uint8)
        skel = post.skeletonize_3d(mask)
        mid = int(np.median(np.nonzero(mask.any(axis=(1, 2)))[0]))
        gap, near = slice(mid - 2, mid + 2), slice(mid - 6, mid + 6)
        broken, in_gap, br_w = mask.copy(), np.zeros_like(skel), np.zeros(mask.shape, np.float16)
        broken[gap] = 0
        in_gap[gap] = skel[gap]
        br_w[near] = mask[near]
        if not in_gap.any():
            raise AssertionError(f"{name}: no skeleton voxel in the break gap")
        files = {("data", "pred_1", name + ".nii.gz"): mask * (np.arange(ENGINE_CUT) <
                                                               ENGINE_CUT // 2)[:, None, None],
                 ("data", "pred_2", name + ".nii.gz"): broken,
                 ("data", "skeleton", name + "mask_cut.nii.gz"): skel}
        for suffix in ("_test", "_val"):
            files[("data", "tree_parse" + suffix, name + "mask_cut.nii.gz")] = branch[sl]
            files[("data", "skeleton" + suffix, name + "mask_cut.nii.gz")] = skel
        arrays = {("data", "LIB_weight", name + ".npy"):
                  lib_weight_map(mask).cpu().numpy().astype(np.float16),
                  ("data", "br_skel", name + ".npy"): np.array(np.nonzero(in_gap)),
                  ("data", "BR_weight", name + ".npy"): br_w}
        for parts, arr in {**files, **arrays}.items():
            path = os.path.join(root, *parts)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if path.endswith(".npy"):
                np.save(path, arr)
            else:
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
    if launches != infer_counts(n):
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


class DriverProbe:
    """Patches of train/stages.py for one driver run: host seconds by part
    (the time blocked on the Prefetcher; the B=8 steps, each to a
    synchronize, since the driver fetches the loss right after it; cache
    writes; the replay pass, ended by a synchronize; validation, likewise;
    checkpoint and resume point; the rest of the wall time as "other"),
    each step's and each validation's launches,
    every step's loss, and with `capture_first` the step count and AdamW
    moments the first step starts from. Every step must launch
    `step_launches`."""

    def __init__(self, capture_first: bool = False, step_launches: dict = STEP_LAUNCHES):
        self.clock = clock = StepClock()
        self.main_s, self.losses, self.val_launches = [], [], []
        self.steps = {"main": 0, "replay": 0}
        self.capture_first, self.first = capture_first, None
        for owner, name, part, sync in ((stages.OnlineCache, "add_batch", "cache_write", False),
                                        (stages, "_replay_pass", "replay", True),
                                        (stages, "save_params", "checkpoint", False),
                                        (stages, "_save_resume_point", "checkpoint", False)):
            clock.patch(owner, name, part, sync)
        validate, make = stages._validate, stages.make_resilient_step

        def timed_validate(*args, **kw):
            before = dict(launch_counts)
            t0 = time.perf_counter()
            out = validate(*args, **kw)
            torch.cuda.synchronize()
            clock.s["validation"] += time.perf_counter() - t0
            self.val_launches.append({k: launch_counts[k] - before[k] for k in launch_counts})
            return out

        class TimedPrefetcher(stages.Prefetcher):
            def __iter__(inner):
                it = super().__iter__()
                while True:
                    t0 = time.perf_counter()
                    item = next(it, None)
                    clock.s["prefetch_wait"] += time.perf_counter() - t0
                    if item is None:
                        return
                    yield item

        def make_timed(*args, **kw):
            step = make(*args, **kw)

            def timed(state, batch, **draws):
                b = batch["image"].shape[0]
                if self.capture_first and self.first is None:
                    self.first = (state.step, {
                        p: {k: v.to("cpu", copy=True) for k, v in state.optimizer.state[t].items()}
                        for p, t in _paths(state.params) if t in state.optimizer.state})
                before = dict(launch_counts)
                t0 = time.perf_counter()
                state, aux = step(state, batch, **draws)
                if b > 1:
                    torch.cuda.synchronize()
                    self.main_s.append(time.perf_counter() - t0)
                    clock.s["main_steps"] += self.main_s[-1]
                diff = {k: launch_counts[k] - before[k] for k in launch_counts}
                if diff != step_launches:
                    raise AssertionError(f"a batch-{b} driver step launched {diff}, want "
                                         f"{step_launches}")
                self.steps["main" if b > 1 else "replay"] += 1
                self.losses.append(aux["loss"])
                return state, aux
            return timed

        for name, fn in (("_validate", timed_validate), ("Prefetcher", TimedPrefetcher),
                         ("make_resilient_step", make_timed)):
            clock.stack.enter_context(mock.patch.object(stages, name, fn))


def check_stage_files(cfg, stage: int, epochs: range, main_steps: int) -> None:
    """The files a driver run writes: a parameter file per epoch, the two
    newest full states, the resume point, a LOG block per validation, the
    TensorBoard records of every main step, and for stages 2/3 a
    non-empty online cache."""
    files = set(os.listdir(cfg.model_savepath))
    want = {f"SE_UNet_{e}.pt" for e in range(epochs.stop)} | {"resume_meta.json"} | {
        f"state_{e}.pt" for e in range(epochs.stop)[-2:]}
    if files != want:
        raise AssertionError(f"stage {stage} wrote {sorted(files)}, want {sorted(want)}")
    blocks = re.findall(r"^epoch:(\d+)$", open(cfg.log_savepath).read(), re.M)
    val_epochs = [epochs.stop - 1] if stage == 1 else list(epochs)
    if [int(e) for e in blocks][-len(val_epochs):] != val_epochs:
        raise AssertionError(f"stage {stage} LOG blocks {blocks}")
    tb = os.path.join(os.path.dirname(cfg.log_savepath), "tb")
    if not any(f.startswith("events.out.tfevents.") for f in os.listdir(tb)):
        raise AssertionError(f"stage {stage}: no TensorBoard record")
    with open(os.path.join(tb, "scalars.jsonl")) as f:
        if sum(1 for _ in f) < main_steps:
            raise AssertionError(f"stage {stage}: fewer TensorBoard scalars than steps")
    if stage > 1 and not os.listdir(os.path.join(cfg.online_savepath, "image")):
        raise AssertionError(f"stage {stage}: empty online cache")


def drivers_path_phase(vol: np.ndarray, lumen: torch.Tensor, branch: np.ndarray,
                       bare_step_s: float) -> None:
    """The curriculum drivers (train/stages.py) at full width, bf16, cube
    128, batch 8, on the two 160^3 cases with every prior (write_cases),
    from the weights of phase 6: train_stage1 for 2 epochs, train_stage2
    for 1 (from stage 1's parameters, pred_1, milestones (40, 60)),
    train_stage3 for 1 (from stage 2's), then train_stage1 again for 3
    epochs on stage 1's directory, which must resume at epoch 2 from the
    saved step and AdamW moments. Per stage: main and replay steps,
    seconds by part, the median B=8 step against train_path's, peak
    memory. Every loss finite; every step launches K1/K2/K5/K6 10/5/5/2
    (the replay's B=1 steps too), every validation 10/5 per tile batch;
    the files each run writes."""
    t_phase = time.perf_counter()
    _, model = get_model(seed=0, compute_dtype=torch.bfloat16)
    params = model.params_tree()
    del model
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data_root, file_root = write_cases(vol, lumen, branch, tmp)
        setup_s = time.perf_counter() - t0

        def cfg(stage: int, epochs: int, start, **kw):
            return stages.StageConfig(
                data_root=data_root, file_root=file_root,
                file_path=os.path.join(file_root, "base_dict.json"),
                model_savepath=os.path.join(tmp, f"stage{stage}", "model"),
                log_savepath=os.path.join(tmp, f"stage{stage}", "LOG.txt"),
                epochs=epochs, batch_size=BATCH, cube=DRIVER_CUBE, start_params=start,
                model_cfg=SEUNetConfig(compute_dtype=torch.bfloat16), **kw)

        hm = {"milestones": (40, 60)}
        runs = [("stage1", 1, range(0, 2), stages.train_stage1, lambda p: cfg(1, 2, p)),
                ("stage2", 2, range(0, 1), stages.train_stage2, lambda p: cfg(
                    2, 1, p, pred_path=os.path.join(file_root, "pred_1"),
                    online_savepath=os.path.join(tmp, "online2"), **hm)),
                ("stage3", 3, range(0, 1), stages.train_stage3, lambda p: cfg(
                    3, 1, p, pred_path=os.path.join(file_root, "pred_2"),
                    br_skel_path=os.path.join(file_root, "br_skel"),
                    br_weight_path=os.path.join(file_root, "BR_weight"),
                    online_savepath=os.path.join(tmp, "online3"), **hm)),
                ("stage1_resume", 1, range(2, 3), stages.train_stage1, lambda p: cfg(1, 3, p))]
        line = {"cube": DRIVER_CUBE, "batch": BATCH, "dtype": "bfloat16",
                "cases": list(ENGINE_CASES),
                "cut": ENGINE_CUT, "write_cases_s": setup_s, "train_path_step_s": bare_step_s}
        n_val = tile_batches((ENGINE_CUT,) * 3, DRIVER_CUBE, DRIVER_CUBE // 2)
        torch.cuda.synchronize()
        reset_launch_counts()
        for name, stage, epochs, train, make_cfg in runs:
            c = make_cfg(params)
            saved = None
            if name == "stage1_resume":
                saved = torch.load(os.path.join(c.model_savepath, "state_1.pt"),
                                   map_location="cpu", weights_only=True)
            probe = DriverProbe(capture_first=saved is not None)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with probe.clock.stack:
                t0 = time.perf_counter()
                state = train(c)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
            losses = [float(v) for v in probe.losses]
            if not losses or not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{name}: losses {losses}")
            want_val = infer_counts(n_val)
            if len(probe.val_launches) != (1 if stage == 1 else len(epochs)) or any(
                    v != want_val for v in probe.val_launches):
                raise AssertionError(f"{name}: validation launches {probe.val_launches}")
            check_stage_files(c, stage, epochs, probe.steps["main"])
            limit = int(len(ENGINE_CASES) * BATCH * 0.3)
            want_steps = {"main": len(ENGINE_CASES) * len(epochs),
                          "replay": 0 if stage == 1 else limit * len(epochs)}
            if probe.steps != want_steps:
                raise AssertionError(f"{name}: steps {probe.steps}, want {want_steps}")
            rec = {"main_steps": probe.steps["main"], "replay_steps": probe.steps["replay"],
                   "wall_s": wall_s, "seconds": dict(probe.clock.s),
                   "main_step_s": probe.main_s,
                   "main_step_s_median": statistics.median(probe.main_s),
                   "median_over_train_path_step": statistics.median(probe.main_s) / bare_step_s,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "losses": losses,
                   "final_step": state.step}
            rec["seconds"]["other"] = wall_s - sum(probe.clock.s.values())
            if saved is not None:
                step0, moments = probe.first
                order = [tuple(p) for p in saved["order"]]
                same = step0 == saved["step"] and len(moments) == len(saved["optimizer"]["state"])
                for i, m in saved["optimizer"]["state"].items():
                    got = moments[order[int(i)]]
                    same &= got.keys() == m.keys() and all(torch.equal(got[k], m[k]) for k in m)
                if not same or state.step != saved["step"] + len(ENGINE_CASES):
                    raise AssertionError(f"resume: started at step {step0} (saved "
                                         f"{saved['step']}), ended at {state.step}; moments "
                                         f"equal: {same}")
                rec["resumed_from_step"] = step0
                rec["moments_equal_saved"] = same
            line[name] = rec
            params = state.params
            del state, probe
        launches = dict(launch_counts)
        if any(launches[k] == 0 for k in ("gathered_epilogue", "phased_epilogue",
                                          "phased_normalize", "max_pool_s2d_bwd")):
            raise AssertionError(f"drivers path launches {launches}")
        line["launches"] = launches
    line["phase_wall_s"] = time.perf_counter() - t_phase
    emit({"drivers_path": line})
    torch.cuda.empty_cache()


def expect_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{what} launched {got}, want {want}")


def curriculum_path_phase(vol: np.ndarray, lumen: torch.Tensor, branch: np.ndarray,
                          bare_step_s: float) -> None:
    """The whole curriculum through its entry point, `cli.train.main`, at
    full width: bf16, cube 128, batch 8, one epoch per stage, remat at
    the CLI's default (on), on the two 160^3 cases. The directory holds
    only the raw data, the masks and base_dict.json: the LIB weights,
    skeletons and parses come from the port's `pipeline.priors`, and the
    run writes pred_1, pred_2, BR_weight and br_skel itself. Per part its
    seconds (priors, each stage, pred_1, pred_2, save_weight_break, the
    DTI validations), per stage what `drivers_path` reports, the
    launches, the voxels of pred_1 / pred_2 and the break skeleton's
    points. Every loss finite, every step 20/5/5/2 launches (remat runs
    the 10 gathered blocks again in the backward), every validation and
    prediction 10/5 per tile batch, the on-disk contract of
    tests/test_full_curriculum.py with `.pt` files. Then
    `save_weight_break` alone on write_cases' hand-broken pred_2: its
    break skeleton must hold every skeleton voxel of the gap, its weight
    be finite and non-zero there."""
    t_phase = time.perf_counter()
    n_tiles = tile_batches((ENGINE_CUT,) * 3, DRIVER_CUBE, DRIVER_CUBE // 2)
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        data_root, file_root = write_raw_cases(vol, lumen, tmp)
        mask_dir, fp = os.path.join(data_root, "mask"), os.path.join(file_root, "base_dict.json")
        pred_names = load_json_file(fp, "0", ("train", "val"))
        val_names = load_json_file(fp, "0", ("val",))
        seconds, line = defaultdict(float), {
            "cube": DRIVER_CUBE, "batch": BATCH, "dtype": "bfloat16", "remat": True,
            "epochs": [1, 1, 1], "cases": list(ENGINE_CASES), "cut": ENGINE_CUT,
            "train_path_step_s": bare_step_s}
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        priors.save_lib_weights(mask_dir, os.path.join(file_root, "LIB_weight"))
        for split, suffix in (("train", ""), ("val", "_val")):
            priors.save_skeletons_and_parses(mask_dir, fp,
                                             os.path.join(file_root, "tree_parse" + suffix),
                                             os.path.join(file_root, "skeleton" + suffix),
                                             split=split)
        seconds["priors"] = time.perf_counter() - t0
        stages_rec, preds, dti = {}, {}, []
        train_fns = {n: getattr(orchestrate, f"train_stage{n}") for n in (1, 2, 3)}
        pred_fn, break_fn, validate_fn = (orchestrate.save_stage_pred,
                                          orchestrate.save_weight_break, engine.validate)

        def timed_stage(n: int):
            def run(cfg):
                probe = DriverProbe(step_launches=REMAT_LAUNCHES)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                with probe.clock.stack:
                    t0 = time.perf_counter()
                    state = train_fns[n](cfg)
                    torch.cuda.synchronize()
                    wall_s = time.perf_counter() - t0
                seconds[f"stage{n}"] += wall_s
                losses = [float(v) for v in probe.losses]
                if not losses or not all(math.isfinite(v) for v in losses):
                    raise AssertionError(f"curriculum stage {n}: losses {losses}")
                want_val = infer_counts(n_tiles * len(val_names))
                if len(probe.val_launches) != 1:
                    raise AssertionError(f"curriculum stage {n}: {len(probe.val_launches)} "
                                         "validations, want 1")
                expect_launches(f"curriculum stage {n}'s validation", probe.val_launches[0],
                                want_val)
                want_steps = {"main": len(ENGINE_CASES),
                              "replay": 0 if n == 1 else int(len(ENGINE_CASES) * BATCH * 0.3)}
                if probe.steps != want_steps:
                    raise AssertionError(f"curriculum stage {n}: steps {probe.steps}, want "
                                         f"{want_steps}")
                rec = {"main_steps": probe.steps["main"], "replay_steps": probe.steps["replay"],
                       "wall_s": wall_s, "seconds": dict(probe.clock.s),
                       "main_step_s": probe.main_s,
                       "main_step_s_median": statistics.median(probe.main_s),
                       "median_over_train_path_step":
                           statistics.median(probe.main_s) / bare_step_s,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "losses": losses}
                rec["seconds"]["other"] = wall_s - sum(probe.clock.s.values())
                stages_rec[f"stage{n}"] = rec
                return state
            return run

        def timed_pred(*args, **kw):
            which = os.path.basename(os.path.normpath(args[4]))
            before = dict(launch_counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pred_fn(*args, **kw)
            torch.cuda.synchronize()
            seconds[which] += time.perf_counter() - t0
            n = n_tiles * len(pred_names)
            preds[which] = {k: launch_counts[k] - before[k] for k in launch_counts}
            expect_launches(which, preds[which],
                            infer_counts(n))
            return out

        def timed_break(*args, **kw):
            t0 = time.perf_counter()
            out = break_fn(*args, **kw)
            seconds["save_weight_break"] += time.perf_counter() - t0
            return out

        def timed_validate(*args, **kw):
            if not args[6].endswith(".dti"):  # a stage's own validation
                return validate_fn(*args, **kw)
            before = dict(launch_counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = validate_fn(*args, **kw)
            torch.cuda.synchronize()
            seconds["dti_validation"] += time.perf_counter() - t0
            got = {k: launch_counts[k] - before[k] for k in launch_counts}
            n = n_tiles * len(val_names)
            expect_launches("a DTI re-validation", got,
                            infer_counts(n))
            dti.append({"stage": kw["stage"], "epoch": args[5], "result": list(out)})
            if not all(math.isfinite(v) for v in out):
                raise AssertionError(f"DTI re-validation: non-finite metric {out}")
            return out

        with contextlib.ExitStack() as stack:
            for owner, name, fn in [*((orchestrate, f"train_stage{n}", timed_stage(n))
                                      for n in (1, 2, 3)),
                                    (orchestrate, "save_stage_pred", timed_pred),
                                    (orchestrate, "save_weight_break", timed_break),
                                    (engine, "validate", timed_validate)]:
                stack.enter_context(mock.patch.object(owner, name, fn))
            t0 = time.perf_counter()
            cli_train.main(["--data_root", data_root, "--file_root", file_root,
                            "--saved_model", os.path.join(tmp, "saved_model"),
                            "--log_dir", os.path.join(tmp, "LOG"), "--epochs", "1", "1", "1",
                            "--batch_size", str(BATCH), "--cube", str(DRIVER_CUBE)])
            torch.cuda.synchronize()
            line["run_s"] = time.perf_counter() - t0
        launches = dict(launch_counts)
        if any(launches[k] == 0 for k in ("gathered_epilogue", "phased_epilogue",
                                          "phased_normalize", "max_pool_s2d_bwd")):
            raise AssertionError(f"curriculum path launches {launches}")
        if len(dti) != 2 or sorted(stages_rec) != ["stage1", "stage2", "stage3"]:
            raise AssertionError(f"curriculum: DTI validations {dti}, stages {sorted(stages_rec)}")
        # the on-disk contract of tests/test_full_curriculum.py, .pt files
        want = [os.path.join(tmp, "saved_model", s, "SE_UNet_0.pt")
                for s in ("stage_one", "stage_two", "stage_three")]
        want += [os.path.join(tmp, "LOG", f) for f in (
            "log_stage_one.txt", "log_stage_two.txt", "log_stage_three.txt",
            "log_stage_two.txt.dti", "log_stage_three.txt.dti")]
        want += [os.path.join(file_root, d, n + x) for n in pred_names
                 for d, x in (("pred_1", ".nii.gz"), ("pred_2", ".nii.gz"),
                              ("BR_weight", ".npy"), ("br_skel", ".npy"))]
        missing = [f for f in want if not os.path.exists(f)]
        if missing:
            raise AssertionError(f"curriculum: missing {missing}")
        line["pred_voxels"] = {
            d: {n: int(read_nifti(os.path.join(file_root, d, n + ".nii.gz")).array.sum())
                for n in ENGINE_CASES} for d in ("pred_1", "pred_2")}
        line["break_skeleton_points"] = {
            n: int(np.load(os.path.join(file_root, "br_skel", n + ".npy")).shape[1])
            for n in ENGINE_CASES}
        line.update(seconds=dict(seconds), stages=stages_rec, pred_launches=preds,
                    dti_validations=dti, launches=launches)

        # save_weight_break alone on write_cases' hand-broken pred_2
        hand = os.path.join(tmp, "hand")
        h_data, h_file = write_cases(vol, lumen, branch, hand)
        out_w, out_s = os.path.join(hand, "BR_weight_port"), os.path.join(hand, "br_skel_port")
        t0 = time.perf_counter()
        priors.save_weight_break(h_data, os.path.join(h_file, "pred_2"), out_w, out_s,
                                 os.path.join(h_file, "base_dict.json"))
        rec = {"s": time.perf_counter() - t0}
        for n in ENGINE_CASES:
            gap = {tuple(c) for c in np.load(os.path.join(h_file, "br_skel", n + ".npy")).T}
            got = {tuple(c) for c in np.load(os.path.join(out_s, n + ".npy")).T}
            w = np.load(os.path.join(out_w, n + ".npy")).astype(np.float32)
            at_gap = w[tuple(np.array(sorted(gap)).T)]
            if not gap <= got or not np.isfinite(w).all() or not (at_gap > 0).all():
                raise AssertionError(
                    f"hand-broken {n}: {len(gap - got)} of {len(gap)} gap skeleton voxels "
                    f"missing from br_skel; weight finite {bool(np.isfinite(w).all())}, "
                    f"min at the gap {float(at_gap.min())}")
            rec[n] = {"gap_skeleton_voxels": len(gap), "break_skeleton_points": len(got),
                      "weight_min_at_gap": float(at_gap.min()),
                      "weight_max": float(w.max())}
        line["hand_broken_weight_break"] = rec
    line["phase_wall_s"] = time.perf_counter() - t_phase
    emit({"curriculum_path": line})
    torch.cuda.empty_cache()


def tree_parsing_phase(lumen: torch.Tensor) -> None:
    """`cli.tree_parsing.main` with --save_path and --save_ATM22_path on
    the phantom's airway lumen at full size: seconds by stage, the
    branch counts of both parsers, which optional renders were written
    (they need matplotlib); each parse map must cover every lumen voxel
    and every artifact that is not a render must exist."""
    t_phase = time.perf_counter()
    mask = lumen.cpu().numpy().astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        masks, ours, atm = (os.path.join(tmp, d) for d in ("masks", "ours", "atm22"))
        os.makedirs(masks)
        write_nifti(os.path.join(masks, "PHANTOM.nii.gz"), mask)
        clock = StepClock()
        for owner, name, step in ((tp_cli, "ours_parse_case", "ours"),
                                  (tp_cli, "atm22_parse_case", "atm22"),
                                  (post_topology.TopologyTree, "sub", "ours_sub"),
                                  (post_topology.TopologyTree, "regrade", "ours_regrade"),
                                  (post_topology.TopologyTree, "parse_map", "ours_parse_map"),
                                  (post_atm22, "atm22_centerline", "atm22_centerline"),
                                  (post_atm22, "atm22_refine", "atm22_refine"),
                                  (post_mesh, "export_mask_stl", "stl")):
            clock.patch(owner, name, step)
        with clock.stack:
            t0 = time.perf_counter()
            tp_cli.main(["--pred_mask_path", masks, "--save_path", ours,
                         "--save_ATM22_path", atm])
            wall_s = time.perf_counter() - t0
        line = {"shape": list(mask.shape), "lumen_voxels": int(mask.sum()), "wall_s": wall_s,
                "seconds": dict(clock.s), "branches": {}, "renders": {}}
        for parser, out, must, renders in (
                ("ours", ours, ("_parse.npy", "_parse_map.nii.gz", "_time.txt", ".stl"),
                 ("_line.png", "_parse.png", "_parse.gif")),
                ("atm22", atm, ("_parse_map.nii.gz", "_time.txt", ".stl"),
                 (".png", "_model.png", ".gif"))):
            missing = [x for x in must if not os.path.exists(os.path.join(out, "PHANTOM" + x))]
            if missing:
                raise AssertionError(f"tree parsing {parser}: missing {missing}")
            parse = read_nifti(os.path.join(out, "PHANTOM_parse_map.nii.gz")).array
            if parse.shape != mask.shape or not (parse[mask > 0] > 0).all():
                raise AssertionError(f"tree parsing {parser}: the parse map leaves "
                                     f"{int((parse[mask > 0] == 0).sum())} lumen voxels out")
            with open(os.path.join(out, "PHANTOM_time.txt")) as f:
                line["branches"][parser] = int(f.read().splitlines()[-1].split()[-1])
            line["renders"][parser] = {x: os.path.exists(os.path.join(out, "PHANTOM" + x))
                                       for x in renders}
    line["phase_wall_s"] = time.perf_counter() - t_phase
    emit({"tree_parsing": line})


def leaf_ratios(got: list, ref: list) -> list:
    """|got - ref| / |ref| of each gradient leaf whose norm is above 1e-6 of
    the largest (a conv bias in front of an InstanceNorm has a gradient
    of rounding alone)."""
    floor = 1e-6 * max(float(r.norm()) for r in ref)
    return [float((a - r).norm() / r.norm()) for a, r in zip(got, ref) if float(r.norm()) > floor]


def worst_leaf(got: list, ref: list) -> dict:
    """The leaf of `leaf_ratios`' largest ratio: its index, shape and norm
    against the largest leaf's."""
    big = max(float(r.norm()) for r in ref)
    i = max((i for i, r in enumerate(ref) if float(r.norm()) > 1e-6 * big),
            key=lambda i: float((got[i] - ref[i]).norm() / ref[i].norm()))
    return {"leaf": i, "shape": list(ref[i].shape), "norm_share": float(ref[i].norm()) / big,
            "ratio": float((got[i] - ref[i]).norm() / ref[i].norm())}


def f32_row_block_grads(batch: dict, draws: list, n: int) -> list:
    """One process's gradient of the f32 check's stage-1 loss formed as n
    ranks form it: the loss sums of n row blocks of the batch, each block
    a forward of its own with its rows of the draws, added, then the loss,
    in one autograd graph; from the weights of seed 3."""
    cfg = SEUNetConfig()
    tree = SEUNet(cfg, generator=torch.Generator().manual_seed(3)).cuda().params_tree()
    params = _tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)
    k = batch["image"].shape[0] // n
    sums = 0
    for r in range(n):
        rows = slice(r * k, (r + 1) * k)
        local = {key: torch.from_numpy(v[rows]).cuda() for key, v in batch.items()}
        p_en, p_de = pstep._heads(se_unet_apply_fast, cfg, params, local["image"],
                                  drop_draws=draws, drop_rows=rows)
        sums = sums + torch.cat([torch.stack(x) for x in pstep._stage_sums(1, p_en, p_de,
                                                                           local)])
    loss, _ = pstep._stage_losses(1, [p.unbind() for p in torch.split(sums, pstep._N_SUMS[1])])
    loss.backward()
    return [torch.zeros(t.shape) if t.grad is None else t.grad.float().cpu()
            for t in _leaves(params)]


def grads_of(state) -> list:
    return [torch.zeros(t.shape) if t.grad is None else t.grad.float().cpu()
            for t in _leaves(state.params)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_one_rank(vol: np.ndarray, lumen: torch.Tensor, bare_step_s: float,
                  trits: np.ndarray) -> dict:
    """One rank on NCCL (`env://` on 127.0.0.1): the sharded stage-1 step
    at 128^3, batch 8, bf16, against the unsharded step on the same batch
    and DropLayer draws, each from the weights of seed 0 and a fresh AdamW
    state, with cuDNN's deterministic algorithms; the unsharded step runs
    twice, for the card's run-to-run spread. The loss within rtol 1e-6,
    each gradient leaf within 1e-6 of its norm beyond that spread, the
    launches 10/5/5/2 each. Then, with cuDNN's defaults, the sharded step's
    seconds: the median of DP_STEPS steps after a warm-up, against
    train_path's bare step. Then the runner on the mesh (bf16, batch 8 on
    the one rank) over the phantom: its tile batches gathered through
    `all_gather_into_tensor` on NCCL (the calls counted: one a tile
    batch), launches 10/5 a tile batch, and at most NCCL_TRIT_BOUND of its
    trits different from main_path's."""
    cfg = SEUNetConfig(compute_dtype=torch.bfloat16)
    batch = phantom_batch(vol, lumen)
    draws = draw_dropout(BATCH, cfg, torch.Generator(device="cuda").manual_seed(6))
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    out, step_s = {}, []
    with mock.patch.dict(os.environ, env):
        mesh = make_mesh(backend="nccl")
        try:
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                            allow_tf32=False):
                for name, m in (("unsharded", None), ("sharded", mesh),
                                ("unsharded_again", None)):
                    tree = SEUNet(cfg, generator=torch.Generator().manual_seed(0)).cuda() \
                        .params_tree()
                    state = create_train_state(tree, make_optimizer()[0])
                    del tree
                    reset_launch_counts()
                    t0 = time.perf_counter()
                    state, aux = make_train_step(cfg, stage=1, mesh=m)(state, batch,
                                                                       drop_draws=draws)
                    out[name] = {"loss": float(aux["loss"]), "grads": grads_of(state),
                                 "launches": dict(launch_counts), "s": time.perf_counter() - t0}
                    del state, aux
                    torch.cuda.empty_cache()
            tree = SEUNet(cfg, generator=torch.Generator().manual_seed(0)).cuda().params_tree()
            state = create_train_state(tree, make_optimizer()[0])
            del tree
            step = make_train_step(cfg, stage=1, mesh=mesh)
            gen = torch.Generator(device="cuda").manual_seed(6)
            for _ in range(DP_STEPS + 1):
                t0 = time.perf_counter()
                state, aux = step(state, batch, gen)
                float(aux["loss"])
                step_s.append(time.perf_counter() - t0)
            del state, step, aux
            torch.cuda.empty_cache()
            cfg_r, model = get_model(seed=0, compute_dtype=torch.bfloat16)
            runner = SlidingWindowRunner(model, cfg_r, cube=128, step=64, batch=BATCH, mesh=mesh)
            del model
            reset_launch_counts()
            with mock.patch.object(dist, "all_gather_into_tensor",
                                   wraps=dist.all_gather_into_tensor) as gathers:
                t0 = time.perf_counter()
                got_trits = runner.predict_trits(vol, h_thresh=0.5, l_thresh=0.35,
                                                 hu_shift=-1024.0)
                torch.cuda.synchronize()
                out["runner"] = {"s_first_volume": time.perf_counter() - t0,
                                 "launches": dict(launch_counts),
                                 "all_gather_into_tensor_calls": gathers.call_count}
            del runner
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    runner = out.pop("runner")
    ref, got = out["unsharded"], out["sharded"]
    spread = max(leaf_ratios(out["unsharded_again"]["grads"], ref["grads"]))
    ratio = max(leaf_ratios(got["grads"], ref["grads"]))
    res = {"backend": mesh.backend, "ranks": mesh.size, "crop": 128, "batch": BATCH,
           "dtype": "bfloat16", "stage": 1, "loss_sharded": got["loss"],
           "loss_unsharded": ref["loss"], "loss_unsharded_again": out["unsharded_again"]["loss"],
           "grad_leaf_norm_ratio_max": ratio, "unsharded_repeat_grad_leaf_norm_ratio_max": spread,
           "launches_sharded": got["launches"],
           "step_s_first": {k: v["s"] for k, v in out.items()}, "step_s_runs": step_s[1:],
           "step_s": statistics.median(step_s[1:]), "bare_step_s": bare_step_s,
           "step_over_bare_step": statistics.median(step_s[1:]) / bare_step_s}
    n_batches = 48 // BATCH
    n_trits = int((got_trits != trits).sum())
    res["runner"] = {"shape": list(SHAPE), "cube": 128, "step": 64, "batch": BATCH,
                     "dtype": "bfloat16", "tile_batches": n_batches, **runner,
                     "trit_voxels_differing_main_path": n_trits,
                     "trit_voxels_differing_bound": NCCL_TRIT_BOUND}
    for k, v in out.items():
        expect_launches(f"the one-rank NCCL check's {k} step", v["launches"], STEP_LAUNCHES)
    expect_launches("the one-rank NCCL runner", runner["launches"],
                    infer_counts(n_batches))
    if runner["all_gather_into_tensor_calls"] != n_batches:
        raise AssertionError(f"the one-rank NCCL runner gathered "
                             f"{runner['all_gather_into_tensor_calls']} times, want {n_batches}")
    if not n_trits <= NCCL_TRIT_BOUND:
        raise AssertionError(f"the one-rank NCCL runner's trits differ from main_path's at "
                             f"{n_trits} voxels")
    if not abs(got["loss"] - ref["loss"]) <= 1e-6 * abs(ref["loss"]):
        raise AssertionError(f"one-rank NCCL step loss {got['loss']} against {ref['loss']}")
    if not ratio <= 1e-6 + spread:
        raise AssertionError(f"one-rank NCCL step gradients: leaf norm ratio {ratio}, the "
                             f"card's repeat {spread}")
    return res


def _dp_rank(mesh, vol: np.ndarray, lumen: np.ndarray, f32_batch: dict, f32_draws: list,
             cases: tuple) -> dict:
    """The two-rank parts of `data_parallel_path` on one rank (gloo, both
    ranks on the one card): (a) three f32 stage-1 steps of 32^3 crops,
    global batch 4, then 1 (replicated), then 4; (b) the stage-1 step at
    128^3, global batch 8 (4 a rank), bf16: a warm-up, DP_STEPS timed
    steps, then DP_ALLREDUCE_STEPS steps that time the gradient
    all_reduce between two synchronizes; (c) the sharded runner (batch 8,
    4 tiles a rank, bf16, the main path's weights) on the phantom: a
    warm-up volume and DP_VOLUMES timed ones; (d) train_stage2 for one
    epoch on the two 160^3 cuts (batch 8, cube 128, bf16). Launches are
    counted from 0 before each part."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    out = {}

    # (a) f32 32^3, cuDNN's deterministic algorithms
    cfg = SEUNetConfig()
    tree = SEUNet(cfg, generator=torch.Generator().manual_seed(3)).to(dev).params_tree()
    state = create_train_state(tree, make_optimizer()[0])
    step = make_train_step(cfg, stage=1, mesh=mesh)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for i, rows in enumerate((slice(0, 4), slice(0, 1), slice(0, 4))):
            state, aux = step(state, {k: v[rows] for k, v in f32_batch.items()},
                              drop_draws=[d[rows] for d in f32_draws])
            if i == 0:
                out["f32_loss"], out["f32_grads"] = float(aux["loss"]), grads_of(state)
    out["f32_params"] = [t.detach().cpu() for t in _leaves(state.params)]
    out["f32_moments"] = [{k: v.cpu() for k, v in state.optimizer.state[t].items()}
                          for t in _leaves(state.params) if t in state.optimizer.state]
    del state, step, tree

    # (b) full width
    cfg = SEUNetConfig(compute_dtype=torch.bfloat16)
    tree = SEUNet(cfg, generator=torch.Generator().manual_seed(0)).to(dev).params_tree()
    state = create_train_state(tree, make_optimizer()[0])
    del tree
    step = make_train_step(cfg, stage=1, mesh=mesh)
    batch = phantom_batch(vol, torch.from_numpy(lumen).to(dev))
    gen = torch.Generator(device=dev).manual_seed(6)
    state, aux = step(state, batch, gen)
    losses = [float(aux["loss"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh.barrier()
    reset_launch_counts()
    step_s = []
    for _ in range(DP_STEPS):
        t0 = time.perf_counter()
        state, aux = step(state, batch, gen)
        losses.append(float(aux["loss"]))
        step_s.append(time.perf_counter() - t0)
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    allreduce_s, real = [], dist.all_reduce

    def timed(t, *a, **kw):
        if t.numel() < 1_000_000:  # the loss sums, not the gradient bucket
            return real(t, *a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real(t, *a, **kw)
        torch.cuda.synchronize()
        allreduce_s.append((time.perf_counter() - t0, t.numel()))
        return res

    with mock.patch.object(dist, "all_reduce", timed):
        for _ in range(DP_ALLREDUCE_STEPS):
            state, aux = step(state, batch, gen)
            losses.append(float(aux["loss"]))
    out["full"] = {"step_s_runs": step_s, "step_s": statistics.median(step_s),
                   "allreduce_s_runs": [a for a, _ in allreduce_s],
                   "allreduce_s": statistics.median(a for a, _ in allreduce_s),
                   "bucket_floats": allreduce_s[0][1], "peak_mem_gb": peak,
                   "launches": launches, "losses": losses}
    del state, step, batch, aux
    torch.cuda.empty_cache()

    # (c) the sharded runner
    cfg, model = get_model(seed=0, compute_dtype=torch.bfloat16, device=dev)
    runner = SlidingWindowRunner(model, cfg, cube=128, step=64, batch=BATCH, mesh=mesh)
    kw = dict(h_thresh=0.5, l_thresh=0.35, hu_shift=-1024.0)
    runner.predict_trits(vol, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    vol_s = []
    for _ in range(DP_VOLUMES):
        mesh.barrier()
        t0 = time.perf_counter()
        trits = runner.predict_trits(vol, **kw)
        torch.cuda.synchronize()
        vol_s.append(time.perf_counter() - t0)
    out["runner"] = {"s_per_volume_runs": vol_s, "s_per_volume": statistics.median(vol_s),
                     "launches": dict(launch_counts),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "trits": trits,
                     "scores": runner.predict_hu(vol, hu_shift=-1024.0)}
    if not mesh.is_main:
        del out["runner"]["scores"]
    del runner, model
    torch.cuda.empty_cache()

    # (d) one train_stage2 epoch
    data_root, file_root, tmp = cases
    probe = DriverProbe()
    writes = {"params": 0, "resume_point": 0, "cache": 0}

    def counting(name, fn):
        def call(*a, **k):
            writes[name] += 1
            return fn(*a, **k)
        return call

    c = dp_stage2_cfg(data_root, file_root, tmp, mesh)
    reset_launch_counts()
    with probe.clock.stack, mock.patch.multiple(
            stages, save_params=counting("params", stages.save_params),
            _save_resume_point=counting("resume_point", stages._save_resume_point)), \
            mock.patch.object(stages.OnlineCache, "add_batch",
                              counting("cache", stages.OnlineCache.add_batch)):
        t0 = time.perf_counter()
        state = stages.train_stage2(c)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    out["drivers"] = {"wall_s": wall_s, "seconds": dict(probe.clock.s), "steps": probe.steps,
                      "main_step_s": probe.main_s, "losses": [float(v) for v in probe.losses],
                      "val_launches": probe.val_launches, "writes": writes,
                      "final_step": state.step, "launches": dict(launch_counts),
                      "params": [t.detach().cpu() for t in _leaves(state.params)]}
    return out


def dp_stage2_cfg(data_root: str, file_root: str, tmp: str, mesh=None):
    """The data-parallel phase's train_stage2 run: 1 epoch, bf16, cube 128,
    batch 8, from the weights of seed 0."""
    _, model = get_model(seed=0, compute_dtype=torch.bfloat16,
                         device=None if mesh is None else mesh.device)
    return stages.StageConfig(
        data_root=data_root, file_root=file_root,
        file_path=os.path.join(file_root, "base_dict.json"),
        model_savepath=os.path.join(tmp, "dp", "model"),
        log_savepath=os.path.join(tmp, "dp", "LOG.txt"), epochs=1, batch_size=BATCH,
        cube=DRIVER_CUBE, milestones=(40, 60), start_params=model.params_tree(),
        pred_path=os.path.join(file_root, "pred_1"),
        online_savepath=os.path.join(tmp, "dp", "online"),
        model_cfg=SEUNetConfig(compute_dtype=torch.bfloat16), mesh=mesh)


def data_parallel_path_phase(vol: np.ndarray, lumen: torch.Tensor, branch: np.ndarray,
                             trits: np.ndarray, bare_step_s: float) -> None:
    """The `data` axis of the mesh (`parallel/mesh.py`) on the one card.
    NCCL does not take two ranks on one card, so: one rank on NCCL (the
    production backend; `nccl_one_rank`), then two ranks sharing the card
    over gloo (`_dp_rank`), whose times are not a scaling figure. Against
    one process on the card: the f32 step's loss and gradients (each leaf
    within DP_F32_LEAF_RTOL of its norm from `f32_row_block_grads`, within
    DP_F32_BATCH_LEAF_RTOL from the B=4 step; cuDNN deterministic on both
    sides, the B=4 step run twice for its spread), the runner's
    scores (within DP_SCORE_ATOL) and trits (at most DP_TRIT_FRACTION of
    them different from main_path's).
    Across the ranks: the f32 parameters and AdamW moments bitwise equal
    after the 3 steps, the runner's trits equal, the drivers' losses and
    parameters equal; every rank's launches 10/5/5/2 a step and 10/5 a tile
    batch; the drivers' files written by rank 0 alone."""
    t_phase = time.perf_counter()
    line = {"ranks_share_one_card": "two ranks on one card: not a scaling figure",
            "nccl_one_rank": nccl_one_rank(vol, lumen, bare_step_s, trits)}
    b, s = DP_F32
    r = np.random.default_rng(4)
    f32_batch = {"image": r.random((b, s, s, s, 2), np.float32),
                 "label": (r.random((b, s, s, s)) > 0.7).astype(np.float32)}
    f32_draws = draw_dropout(b, SEUNetConfig(), torch.Generator().manual_seed(4))
    f32_ref = []  # the one-process step twice: the card's run-to-run spread
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for _ in range(2):
            tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(3)).cuda() \
                .params_tree()
            state = create_train_state(tree, make_optimizer()[0])
            state, aux = make_train_step(SEUNetConfig(), stage=1)(
                state, {k: torch.from_numpy(v).cuda() for k, v in f32_batch.items()},
                drop_draws=f32_draws)
            f32_ref.append((float(aux["loss"]), grads_of(state)))
            del tree, state, aux
        f32_blocks = f32_row_block_grads(f32_batch, f32_draws, DP_RANKS)
    (f32_loss, f32_grads), f32_again = f32_ref
    cfg, model = get_model(seed=0, compute_dtype=torch.bfloat16)
    scores = SlidingWindowRunner(model, cfg, cube=128, step=64, batch=BATCH).predict_hu(
        vol, hu_shift=-1024.0)
    del model
    with tempfile.TemporaryDirectory() as tmp:
        data_root, file_root = write_cases(vol, lumen, branch, tmp)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn(_dp_rank, DP_RANKS, vol, lumen.cpu().numpy(), f32_batch, f32_draws,
                      (data_root, file_root, tmp), devices=["cuda:0"] * DP_RANKS, threads=2,
                      timeout_s=900)
        spawn_s = time.perf_counter() - t0
        check_stage_files(dp_stage2_cfg(data_root, file_root, tmp), 2, range(0, 1),
                          ranks[0]["drivers"]["steps"]["main"])
    n_batches = 48 // BATCH
    r0 = ranks[0]
    ratios = leaf_ratios(r0["f32_grads"], f32_grads)
    block_ratios = leaf_ratios(r0["f32_grads"], f32_blocks)
    repeat = max(leaf_ratios(f32_again[1], f32_grads))
    diff = np.abs(r0["runner"]["scores"] - scores)
    n_trits = int((r0["runner"]["trits"] != trits).sum())
    line.update({
        "backend": "gloo", "ranks": DP_RANKS, "spawn_wall_s": spawn_s,
        "f32_step": {"crop": s, "global_batch": b, "loss_ranks": r0["f32_loss"],
                     "loss_one_process": f32_loss, "grad_leaf_norm_ratio_max": max(ratios),
                     "grad_worst_leaf": worst_leaf(r0["f32_grads"], f32_grads),
                     "one_process_repeat_grad_leaf_norm_ratio_max": repeat,
                     "row_blocks_grad_leaf_norm_ratio_max": max(block_ratios),
                     "row_blocks_grad_worst_leaf": worst_leaf(r0["f32_grads"], f32_blocks),
                     "row_blocks_one_process_grad_leaf_norm_ratio_max":
                         max(leaf_ratios(f32_blocks, f32_grads)),
                     "loss_rtol_bound": DP_F32_LOSS_RTOL,
                     "grad_leaf_norm_ratio_bound": DP_F32_BATCH_LEAF_RTOL,
                     "row_blocks_grad_leaf_norm_ratio_bound": DP_F32_LEAF_RTOL,
                     "cudnn": "deterministic", "steps": "4, 1 (replicated), 4"},
        "train_step": {"crop": 128, "global_batch": BATCH, "batch_per_rank": BATCH // DP_RANKS,
                       "dtype": "bfloat16", "stage": 1, "bare_step_s_one_process": bare_step_s,
                       "gradient_bucket_mb": 4 * r0["full"]["bucket_floats"] / 1e6,
                       **{f"rank{i}": {k: v for k, v in r["full"].items() if k != "bucket_floats"}
                          for i, r in enumerate(ranks)}},
        "runner": {"shape": list(SHAPE), "cube": 128, "step": 64, "batch": BATCH,
                   "tiles_per_rank": BATCH // DP_RANKS, "dtype": "bfloat16",
                   "gather_mb_per_tile_batch": BATCH * 128 ** 3 * 4 / 1e6,
                   "tile_batches": n_batches,
                   "score_max_abs_diff_one_process": float(diff.max()),
                   "score_max_abs_diff_bound": DP_SCORE_ATOL,
                   "trit_voxels_differing_main_path": n_trits,
                   "trit_voxels_differing_bound": int(DP_TRIT_FRACTION * trits.size),
                   **{f"rank{i}": {k: v for k, v in r["runner"].items()
                                   if k not in ("trits", "scores")}
                      for i, r in enumerate(ranks)}},
        "drivers": {"stage": 2, "epochs": 1, "cases": list(ENGINE_CASES), "cut": ENGINE_CUT,
                    **{f"rank{i}": {k: v for k, v in r["drivers"].items() if k != "params"}
                       for i, r in enumerate(ranks)}},
        "phase_wall_s": time.perf_counter() - t_phase})
    emit({"data_parallel_path": line})

    if not abs(r0["f32_loss"] - f32_loss) <= DP_F32_LOSS_RTOL * abs(f32_loss) or \
            not max(block_ratios) <= DP_F32_LEAF_RTOL or \
            not max(ratios) <= DP_F32_BATCH_LEAF_RTOL:
        raise AssertionError(f"two-rank f32 step: loss {r0['f32_loss']} against {f32_loss}, "
                             f"leaf norm ratio {max(block_ratios)} against the row blocks, "
                             f"{max(ratios)} against the B={b} step")
    for name, kind in (("f32_params", None), ("f32_moments", dict)):
        for a, b_ in zip(r0[name], ranks[1][name]):
            same = (a.keys() == b_.keys() and all(torch.equal(a[k], b_[k]) for k in a)
                    if kind is dict else torch.equal(a, b_))
            if not same:
                raise AssertionError(f"the ranks' {name} differ after the replicated step")
    for i, r in enumerate(ranks):
        expect_launches(f"rank {i}'s train steps", r["full"]["launches"],
                        {k: v * DP_STEPS for k, v in STEP_LAUNCHES.items()})
        expect_launches(f"rank {i}'s runner", r["runner"]["launches"],
                        infer_counts(n_batches * DP_VOLUMES))
        if not all(math.isfinite(v) for v in r["full"]["losses"] + r["drivers"]["losses"]):
            raise AssertionError(f"rank {i}: non-finite losses")
        want_steps = {"main": len(ENGINE_CASES), "replay": int(len(ENGINE_CASES) * BATCH * 0.3)}
        if r["drivers"]["steps"] != want_steps:
            raise AssertionError(f"rank {i}: driver steps {r['drivers']['steps']}")
    if not np.array_equal(r0["runner"]["trits"], ranks[1]["runner"]["trits"]):
        raise AssertionError("the ranks' trit fields differ")
    if not diff.max() <= DP_SCORE_ATOL:
        raise AssertionError(f"sharded runner scores differ by {diff.max()} from one process")
    if not n_trits <= DP_TRIT_FRACTION * trits.size:
        raise AssertionError(f"the sharded runner's trits differ from main_path's at {n_trits} "
                             f"voxels")
    if r0["drivers"]["losses"] != ranks[1]["drivers"]["losses"] or not all(
            torch.equal(a, b_) for a, b_ in zip(r0["drivers"]["params"],
                                                 ranks[1]["drivers"]["params"])):
        raise AssertionError("the ranks' driver losses or parameters differ")
    want_val = infer_counts(tile_batches((ENGINE_CUT,) * 3, DRIVER_CUBE, DRIVER_CUBE // 2))
    if r0["drivers"]["val_launches"] != [want_val]:
        raise AssertionError(f"rank 0's validation launched {r0['drivers']['val_launches']}")
    if r0["drivers"]["writes"] != {"params": 1, "resume_point": 1,
                                   "cache": len(ENGINE_CASES)} or any(
            ranks[1]["drivers"]["writes"].values()):
        raise AssertionError(f"driver writes: rank 0 {r0['drivers']['writes']}, rank 1 "
                             f"{ranks[1]['drivers']['writes']}")
    torch.cuda.empty_cache()


def slab_kernel_lines() -> dict:
    """K1, K2 and K5 at the depth-slab shapes of the space path (8 crops of
    128^3 on 2 space ranks: (8, 32, 64, 64, 8C) at the full grid, (8, 16,
    32, 32, 8C) at the 1/2 grid; the phased forms on the (nz+1, n+1, n+1)
    window grid), each against its plain version with the kernel phase's
    checks (K1/K2 `bf16_mismatch`, K5 one bf16 ulp), with ms and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    dev = torch.device("cuda")
    out = {"gathered_epilogue": [], "phased_epilogue": [], "phased_normalize": []}
    calls = [("gathered_epilogue", *c) for c in GATHERED] + \
        [("phased_epilogue", *c) for c in PHASED] + \
        [("phased_normalize", blk, n, c8, 0) for blk, n, c8, _ in PHASED]
    for kind, block, n, c8, gates in calls:
        nz = n // SP_RANKS
        ext = 0 if kind == "gathered_epilogue" else 1
        y = torch.randn((BATCH, nz + ext, n + ext, n + ext, c8), generator=gen,
                        device=dev).to(torch.bfloat16)
        scale8 = 0.5 + torch.rand((BATCH, c8), generator=gen, device=dev)
        shift8 = 0.3 * torch.randn((BATCH, c8), generator=gen, device=dev)
        wse = (0.1 * torch.randn((gates, c8 // 8), generator=gen, device=dev)).to(
            torch.bfloat16) if gates else None
        args = (y, scale8, shift8) + ((wse,) if kind != "phased_normalize" else ())
        kernel, plain = getattr(eps, kind), getattr(eps, kind + "_plain")
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if kind == "phased_normalize":
            d = (got.float() - ref.float()).abs()
            err, ok = float(d.max()), bool((d <= bf16_ulp(ref)).all())
        else:
            err, ok = bf16_mismatch(got, ref)
        if not ok or got.shape != (BATCH, nz, n, n, c8) or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{kind} {block} on a depth slab {tuple(y.shape)}: kernel "
                                 f"disagrees with its plain version (max |d| {err})")
        b_ms, b_by = bound(2, got.numel(), c8, gates)
        out[kind].append({"block": block, "shape": list(y.shape), "gates": gates,
                          "design": eps.pick_design(y, ext == 1),
                          "ms": cuda_ms(lambda: kernel(*args)), "bound_ms": b_ms,
                          "bound_by": b_by, "max_abs_diff": err})
        del y, got, ref
    torch.cuda.empty_cache()
    return out


def _timed_exchanges(records: list):
    """Patches for the space axis's two collectives that synchronize
    around each call and record (kind, seconds, buffer bytes)."""
    from se_unet_airseg_tpu_torch.parallel import mesh as pmesh

    def wrap(kind, fn):
        def call(t, mesh):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(t, mesh)
            torch.cuda.synchronize()
            records.append((kind, time.perf_counter() - t0, t.numel() * t.element_size()))
            return out
        return call

    return mock.patch.multiple(pmesh, _exchange_planes=wrap("halo", pmesh._exchange_planes),
                               _space_reduce=wrap("space_sum", pmesh._space_reduce))


def _space_rank(mesh, vol: np.ndarray, lumen: np.ndarray, f32_batch: dict,
                f32_draws: list) -> dict:
    """The two-rank parts of `space_path` on one rank of the (1, 2) mesh
    (gloo, both ranks on the one card): (a) the f32 stage-3 step of 32^3
    crops, global batch 2, depth split, cuDNN deterministic; (b) the
    stage-1 step at 128^3, batch 8, bf16, depth split: a warm-up, SP_STEPS
    timed steps, then one step with every halo exchange and sum timed
    between two synchronizes; (c) the depth-split runner (batch 8, bf16, the
    main path's weights) on the phantom. Launches are counted from 0
    before (b)'s timed steps and (c)'s timed volume."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    out = {}

    # (a) f32 parity, cuDNN's deterministic algorithms
    cfg = SEUNetConfig()
    tree = SEUNet(cfg, generator=torch.Generator().manual_seed(3)).to(dev).params_tree()
    state = create_train_state(tree, make_optimizer()[0])
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        state, aux = make_train_step(cfg, stage=3, mesh=mesh, shard_space=True)(
            state, f32_batch, drop_draws=f32_draws)
    out["f32"] = {"loss": float(aux["loss"]), "grads": grads_of(state),
                  "params": [t.detach().cpu() for t in _leaves(state.params)],
                  "per_crop_gul": aux["per_crop_gul"].cpu()}
    del state, tree, aux

    # (b) full width
    cfg = SEUNetConfig(compute_dtype=torch.bfloat16)
    tree = SEUNet(cfg, generator=torch.Generator().manual_seed(0)).to(dev).params_tree()
    state = create_train_state(tree, make_optimizer()[0])
    del tree
    step = make_train_step(cfg, stage=1, mesh=mesh, shard_space=True)
    batch = phantom_batch(vol, torch.from_numpy(lumen).to(dev))
    gen = torch.Generator(device=dev).manual_seed(6)
    state, aux = step(state, batch, gen)
    losses = [float(aux["loss"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh.barrier()
    reset_launch_counts()
    step_s = []
    for _ in range(SP_STEPS):
        t0 = time.perf_counter()
        state, aux = step(state, batch, gen)
        losses.append(float(aux["loss"]))
        step_s.append(time.perf_counter() - t0)
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    records = []
    with _timed_exchanges(records):
        t0 = time.perf_counter()
        state, aux = step(state, batch, gen)
        losses.append(float(aux["loss"]))
        timed_step_s = time.perf_counter() - t0
    halo = [r for r in records if r[0] == "halo"]
    sums = [r for r in records if r[0] == "space_sum"]
    out["full"] = {"step_s_runs": step_s, "step_s": statistics.median(step_s),
                   "peak_mem_gb": peak, "launches": launches, "losses": losses,
                   "halo_exchanges": len(halo),
                   "halo_buffer_bytes": sum(r[2] for r in halo),
                   "halo_own_planes_bytes": sum(r[2] for r in halo) // mesh.space_size,
                   "halo_s": sum(r[1] for r in halo),
                   "space_sums": len(sums), "space_sum_bytes": sum(r[2] for r in sums),
                   "space_sum_s": sum(r[1] for r in sums),
                   "instrumented_step_s": timed_step_s}
    del state, step, batch, aux
    torch.cuda.empty_cache()

    # (c) the depth-split eval forward
    cfg, model = get_model(seed=0, compute_dtype=torch.bfloat16, device=dev)
    runner = SlidingWindowRunner(model, cfg, cube=128, step=64, batch=BATCH, mesh=mesh)
    kw = dict(h_thresh=0.5, l_thresh=0.35, hu_shift=-1024.0)
    runner.predict_trits(vol, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh.barrier()
    reset_launch_counts()
    t0 = time.perf_counter()
    trits = runner.predict_trits(vol, **kw)
    torch.cuda.synchronize()
    out["runner"] = {"s_per_volume": time.perf_counter() - t0, "launches": dict(launch_counts),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "trits": trits,
                     "scores": runner.predict_hu(vol, hu_shift=-1024.0)}
    if not mesh.is_main:
        del out["runner"]["scores"]
    return out


def space_path_phase(vol: np.ndarray, lumen: torch.Tensor, trits: np.ndarray,
                     bare_step_s: float, peak_gb: float) -> None:
    """The mesh's `space` axis (each crop's depth split over ranks) on the
    one card: K1/K2/K5 at the slab shapes against their plain versions,
    then two ranks sharing the card over gloo, a (data 1, space 2) mesh
    (`_space_rank`; their times are not a scaling figure). Against one
    process on the card: the f32 32^3 step's loss (SP_F32_LOSS_RTOL),
    per-crop GUL and gradients (each leaf within SP_F32_LEAF_RTOL of its
    norm; the one-process step run twice for the card's spread); the
    runner's scores (SP_SCORE_ATOL) and trits against main_path's (at most
    SP_TRIT_FRACTION differ). Across the ranks: the f32 parameters bitwise
    equal, the runner's trits equal; every rank's launches 10/5/5/2 a step
    and 10/5 a tile batch; every loss finite."""
    t_phase = time.perf_counter()
    line = {"ranks_share_one_card": "two ranks on one card: not a scaling figure",
            "mesh": {"data": 1, "space": SP_RANKS}, "backend": "gloo",
            "slab_kernels": slab_kernel_lines()}
    b, s = SP_F32
    r = np.random.default_rng(8)
    f32_batch = {"image": r.random((b, s, s, s, 2), np.float32),
                 "label": (r.random((b, s, s, s)) > 0.7).astype(np.float32),
                 "weight": r.random((b, s, s, s)).astype(np.float32),
                 "skel": (r.random((b, s, s, s)) > 0.9).astype(np.float32)}
    f32_draws = draw_dropout(b, SEUNetConfig(), torch.Generator().manual_seed(8))
    ref = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for _ in range(2):
            tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(3)).cuda() \
                .params_tree()
            state = create_train_state(tree, make_optimizer()[0])
            state, aux = make_train_step(SEUNetConfig(), stage=3)(
                state, {k: torch.from_numpy(v).cuda() for k, v in f32_batch.items()},
                drop_draws=f32_draws)
            ref.append((float(aux["loss"]), grads_of(state), aux["per_crop_gul"].cpu()))
            del tree, state, aux
    cfg, model = get_model(seed=0, compute_dtype=torch.bfloat16)
    scores = SlidingWindowRunner(model, cfg, cube=128, step=64, batch=BATCH).predict_hu(
        vol, hu_shift=-1024.0)
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(_space_rank, SP_RANKS, vol, lumen.cpu().numpy(), f32_batch, f32_draws,
                  devices=["cuda:0"] * SP_RANKS, threads=2, timeout_s=300, n_space=SP_RANKS)
    spawn_s = time.perf_counter() - t0
    (loss1, grads1, gul1), (_, grads_again, _) = ref
    r0 = ranks[0]
    ratios = leaf_ratios(r0["f32"]["grads"], grads1)
    diff = np.abs(r0["runner"]["scores"] - scores)
    n_trits = int((r0["runner"]["trits"] != trits).sum())
    n_batches = 48 // BATCH
    line.update({
        "spawn_wall_s": spawn_s,
        "f32_step": {"crop": s, "global_batch": b, "stage": 3, "loss_ranks": r0["f32"]["loss"],
                     "loss_one_process": loss1,
                     "per_crop_gul_max_abs_diff": float((r0["f32"]["per_crop_gul"]
                                                         - gul1).abs().max()),
                     "grad_leaf_norm_ratio_max": max(ratios),
                     "grad_worst_leaf": worst_leaf(r0["f32"]["grads"], grads1),
                     "one_process_repeat_grad_leaf_norm_ratio_max":
                         max(leaf_ratios(grads_again, grads1)),
                     "loss_rtol_bound": SP_F32_LOSS_RTOL,
                     "grad_leaf_norm_ratio_bound": SP_F32_LEAF_RTOL, "cudnn": "deterministic"},
        "train_step": {"crop": 128, "global_batch": BATCH, "depth_per_rank": 128 // SP_RANKS,
                       "dtype": "bfloat16", "stage": 1, "bare_step_s_one_process": bare_step_s,
                       "train_path_peak_mem_gb": peak_gb,
                       **{f"rank{i}": r["full"] for i, r in enumerate(ranks)}},
        "runner": {"shape": list(SHAPE), "cube": 128, "step": 64, "batch": BATCH,
                   "depth_per_rank": 128 // SP_RANKS, "dtype": "bfloat16",
                   "tile_batches": n_batches,
                   "score_max_abs_diff_one_process": float(diff.max()),
                   "score_max_abs_diff_bound": SP_SCORE_ATOL,
                   "trit_voxels_differing_main_path": n_trits,
                   "trit_voxels_differing_bound": int(SP_TRIT_FRACTION * trits.size),
                   **{f"rank{i}": {k: v for k, v in r["runner"].items()
                                   if k not in ("trits", "scores")}
                      for i, r in enumerate(ranks)}},
        "phase_wall_s": time.perf_counter() - t_phase})
    emit({"space_path": line})

    if not abs(r0["f32"]["loss"] - loss1) <= SP_F32_LOSS_RTOL * abs(loss1) or \
            not max(ratios) <= SP_F32_LEAF_RTOL:
        raise AssertionError(f"depth-split f32 step: loss {r0['f32']['loss']} against {loss1}, "
                             f"leaf norm ratio {max(ratios)}")
    if not torch.allclose(r0["f32"]["per_crop_gul"], gul1, rtol=SP_F32_LOSS_RTOL, atol=0):
        raise AssertionError("depth-split per-crop GUL differs from one process")
    if not all(torch.equal(a, b_) for a, b_ in zip(r0["f32"]["params"],
                                                    ranks[1]["f32"]["params"])):
        raise AssertionError("the ranks' parameters differ after the depth-split step")
    for i, r in enumerate(ranks):
        expect_launches(f"rank {i}'s depth-split train steps", r["full"]["launches"],
                        {k: v * SP_STEPS for k, v in STEP_LAUNCHES.items()})
        expect_launches(f"rank {i}'s depth-split runner", r["runner"]["launches"],
                        infer_counts(n_batches))
        if not all(math.isfinite(v) for v in r["full"]["losses"]):
            raise AssertionError(f"rank {i}: non-finite losses {r['full']['losses']}")
    if not np.array_equal(r0["runner"]["trits"], ranks[1]["runner"]["trits"]):
        raise AssertionError("the ranks' trit fields differ")
    if not diff.max() <= SP_SCORE_ATOL:
        raise AssertionError(f"depth-split runner scores differ by {diff.max()} from one "
                             f"process")
    if not n_trits <= SP_TRIT_FRACTION * trits.size:
        raise AssertionError(f"the depth-split runner's trits differ from main_path's at "
                             f"{n_trits} voxels")
    torch.cuda.empty_cache()


# the kernels of the dry run's one-process half: (module, window planes
# beyond the depth extent nz: 1 for the phased forms' (nz+1) grid)
DRYRUN_KERNELS = {"gathered_epilogue": (eps, 0), "phased_epilogue": (eps, 1),
                  "phased_normalize": (eps, 1), "max_pool_s2d_bwd": (ps2d, 0)}


def _rank_part(kind: str, args: tuple, n_data: int, n_space: int) -> tuple | None:
    """The part of one kernel call's inputs that one rank of an (n_data,
    n_space) mesh gives the kernel: its data row's crops (at least one)
    and its depth slab (nz / n_space planes, and the phased forms' extra
    window plane); None when the depth does not split evenly. A
    contiguous input stays contiguous, as the rank's own conv output is."""
    ext = DRYRUN_KERNELS[kind][1]
    y = args[0]
    if (y.shape[1] - ext) % n_space:
        return None
    b, d = max(1, y.shape[0] // n_data), (y.shape[1] - ext) // n_space + ext
    part = y[:b, :d].contiguous() if y.is_contiguous() else y[:b, :d]
    if kind == "max_pool_s2d_bwd":
        return (part,) + tuple(None if g is None else g[:b, :d].contiguous() for g in args[1:])
    return (part,) + tuple(t[:b].contiguous() for t in args[1:3]) + tuple(args[3:])


def held_dryrun_kernels(mesh: tuple) -> dict:
    """The one-process half of `dryrun_multichip(4)` (`entry._dryrun`) on
    the card with every launch of K1, K2, K5 and K6 held against its plain
    version on the same float32 inputs, and again on the part of them that
    one rank of the `mesh` (data, space) gives the kernel (`_rank_part`):
    the epilogues within F32_EPI_ATOL + F32_EPI_RTOL |plain|, the pool
    backward exactly. The sharded ranks' outputs are held against this
    process's by dryrun_multichip. Returns per kernel the path's launches,
    its input shapes and designs and the largest |kernel - plain|."""
    stats = {k: {"launches": 0, "shapes": set(), "designs": set(), "max_abs_diff": 0.0}
             for k in DRYRUN_KERNELS}

    def hold(kind, kernel, plain, args, got=None):
        with torch.no_grad():
            got = kernel(*args) if got is None else got
            ref = plain(*args)
        d = (got.float() - ref.float()).abs()
        tol = 0 if kind == "max_pool_s2d_bwd" else F32_EPI_ATOL + F32_EPI_RTOL * ref.abs()
        st = stats[kind]
        st["shapes"].add(tuple(args[0].shape))
        if kind != "max_pool_s2d_bwd":
            st["designs"].add(eps.pick_design(args[0], DRYRUN_KERNELS[kind][1] == 1))
        st["max_abs_diff"] = max(st["max_abs_diff"], float(d.max()))
        if args[0].dtype != torch.float32 or got.shape != ref.shape or \
                not bool((d <= tol).all()) or not torch.isfinite(got).all():
            raise AssertionError(f"{kind} on the dry run's {args[0].dtype} input "
                                 f"{tuple(args[0].shape)}: kernel disagrees with its plain "
                                 f"version (max |d| {float(d.max())})")

    def wrap(kind):
        owner = DRYRUN_KERNELS[kind][0]
        kernel, plain = getattr(owner, kind), getattr(owner, kind + "_plain")

        def call(*args):
            out = kernel(*args)
            stats[kind]["launches"] += 1
            hold(kind, kernel, plain, args, out)
            part = _rank_part(kind, args, *mesh)
            if part is not None:
                hold(kind, kernel, plain, part)
            return out
        return call

    with contextlib.ExitStack() as stack:
        for kind, (owner, _) in DRYRUN_KERNELS.items():
            stack.enter_context(mock.patch.object(owner, kind, wrap(kind)))
        _dryrun(None, mesh[0] * mesh[1], torch.device("cuda"))
    torch.cuda.empty_cache()
    return {k: {"launches": v["launches"], "shapes": sorted(map(list, v["shapes"])),
                "designs": sorted(v["designs"]), "max_abs_diff": v["max_abs_diff"]}
            for k, v in stats.items()}


def dryrun_path_phase() -> None:
    """`entry.dryrun_multichip(4)` on the card: 4 gloo ranks sharing it as a
    (data 2, space 2) mesh (not a scaling figure). The f32 stage-3 step on
    16^3 crops and the runner (cube 32) against one process: the loss
    within SP_F32_LOSS_RTOL, each gradient leaf within SP_F32_LEAF_RTOL of
    its norm, the parameters bitwise equal across the ranks, the scores
    within FORWARD_ATOL; then the f32 eval forward of 2 crops of 128^3
    split over data and space: finite and within FORWARD_ATOL of one
    process (dryrun_multichip raises otherwise), with its seconds and each
    rank's peak memory. Then the one-process half again with every kernel
    launch held against its plain version (`held_dryrun_kernels`)."""
    t0 = time.perf_counter()
    out = dryrun_multichip(4)
    out["phase_wall_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    try:
        out["kernels_held"] = held_dryrun_kernels(tuple(out["mesh"]))
    finally:
        out["kernels_held_s"] = time.perf_counter() - t1
        emit({"dryrun_path": out})
    if out["forward"]["crop"] != 128 or out["mesh"] != [2, 2]:
        raise AssertionError(f"the dry run ran {out['mesh']} at {out['forward']['crop']}^3")
    if not (abs(out["loss"] - out["loss_one_process"]) <= SP_F32_LOSS_RTOL
            * abs(out["loss_one_process"]) and out["ranks_equal"]
            and out["grad_leaf_norm_ratio_max"] <= SP_F32_LEAF_RTOL
            and out["score_max_abs_diff"] <= FORWARD_ATOL):
        raise AssertionError(f"the dry run's step or runner differs from one process: {out}")
    if not all(v["launches"] for v in out["kernels_held"].values()):
        raise AssertionError(f"a kernel of the dry run was not launched: "
                             f"{out['kernels_held']}")


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
    emit({"devices": {"device_summary": device_summary(),
                      "pick_devices(1, 40.0)": [str(d) for d in pick_devices(1, 40.0)]}})
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
            "ptxas": named_report(ptxas, ("ring_kernel", "reg_kernel"))},
        "norm_stats": {"ptxas": named_report(ptxas, ("norm_stats_",))}}})

    summary = kernel_phase()
    summary.update(train_kernel_phase())
    summary.update(conv_stats_kernel_phase())
    summary.update(conv_epi_kernel_phase())
    nl_summary, nl_launches = norm_leaky_phase()
    summary.update(nl_summary)
    summary.update(norm_stats_phase())
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
    train_launches, bare_step_s, train_batch, train_draws, train_peak_gb = \
        train_path_phase(vol, lumen)
    config_train_path_phase(train_batch)
    remat_phase(train_batch, train_draws)
    del train_batch, train_draws
    engine_path_phase(vol, lumen, branch)
    emit({"drivers_batch1_kernels": train_kernel_phase(batch=1)})
    drivers_path_phase(vol, lumen, branch, bare_step_s)
    curriculum_path_phase(vol, lumen, branch, bare_step_s)
    tree_parsing_phase(lumen)
    data_parallel_path_phase(vol, lumen, branch, trits, bare_step_s)
    space_path_phase(vol, lumen, trits, bare_step_s, train_peak_gb)
    dryrun_path_phase()
    # each kernel's launches from the path that runs it
    launches = {**{k: main_launches[k] for k in (*EPILOGUE_TABLES, "norm_stats")},
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
