"""Whole CT volumes through the sliding-window runner under Swin UNETR,
one after another.

The stream of `infer_stream` (the same mix keys: `shapes`, `volumes`,
`cube`, `step`, `batch`, `h_thresh`, `l_thresh`, `hu_shift`, `warmup`,
`trace_volumes`, `check_volumes`), with the configuration's Swin UNETR in
the runner: weights from `reference/swinunetr.py::make_weights` and the
run's seed, handed to `SlidingWindowRunner(params, SwinUNETRConfig(...))`.
It takes from the program `models.swin_unetr.SwinUNETRConfig` beside the
names of `program.py`; a program without it fails at the start of `run`.

The check, `trit_flips`: of each checked volume, the voxels whose trit
differs from the plain float32 Swin UNETR's (`reference/swinunetr.py`),
over those of the same reference with the inputs of every conv, linear
layer and attention product rounded to bfloat16, the configuration's
precision (at least `infer_stream.FLOOR_FLIPS`).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .. import counts, program
from ..harness import Check, Outcome, Record, log
from ..reference import swinunetr as ref
from ..reference.seunet import no_tf32
from ..trace import SLICE, Trace
from .infer_stream import FLOOR_FLIPS, _tiles


def model_config(conf: dict):
    """The program's Swin UNETR configuration from a configuration file's
    settings."""
    from se_unet_airseg_tpu_torch.models.swin_unetr import SwinUNETRConfig

    return SwinUNETRConfig(in_channels=conf["in_channels"], out_channels=conf["out_channels"],
                           feature_size=conf["feature_size"], depths=tuple(conf["depths"]),
                           num_heads=tuple(conf["num_heads"]),
                           window_size=conf["window_size"], patch_size=conf["patch_size"],
                           mlp_ratio=conf["mlp_ratio"], normalize=conf["normalize"],
                           compute_dtype=getattr(torch, conf["compute_dtype"]))


def checked_flips(sd: dict, spec, vol: np.ndarray, got: np.ndarray, mix: dict, dev,
                  quant: str = "bf16") -> tuple[int, int]:
    """(trits of `got` off the float32 reference's, the `quant` reference's
    off it) of one volume."""
    kw = dict(cube=mix["cube"], step=mix["step"], batch=mix["batch"], h=mix["h_thresh"],
              l=mix["l_thresh"], hu_shift=mix["hu_shift"], device=dev)
    with no_tf32():
        f32 = ref.predict_trits(sd, vol, spec, **kw)
        low = ref.predict_trits(sd, vol, spec, quant=quant, **kw)
    return int(np.count_nonzero(f32 != got)), int(np.count_nonzero(f32 != low))


def run(ctx) -> Outcome:
    mix, dev = ctx.mix, torch.device(ctx.device)
    cfg = model_config(ctx.config)
    spec = ref.Spec.from_config(ctx.config)
    sd = ref.make_weights(ctx.seed, dev, spec)
    runner = program.SlidingWindowRunner(sd, cfg, cube=mix["cube"], step=mix["step"],
                                         batch=mix["batch"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed % 2**63)
    shapes = [tuple(s) for s in mix["shapes"]]
    vols = [counts.phantom(shapes[i % len(shapes)], gen, dev)[0]
            for i in range(mix["volumes"])]
    log(f"weights and {len(vols)} volumes made")
    kw = dict(h_thresh=mix["h_thresh"], l_thresh=mix["l_thresh"], hu_shift=mix["hu_shift"])
    for i in mix["warmup"]:
        runner.predict_trits(vols[i], **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    log("warm-up done; window starts")
    outs, dispatch = [], []
    t_start = time.perf_counter()
    while True:
        vol = vols[len(outs) % len(vols)]
        if ctx.trace:
            t = time.perf_counter()
            handle = runner.predict_trits_summary_device(vol, **kw)
            dispatch.append(time.perf_counter() - t)
            outs.append(program.fetch_trits(handle))
        else:
            outs.append(runner.predict_trits(vol, **kw))
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    done = [vols[i % len(vols)].shape for i in range(len(outs))]
    tiles = [_tiles(s, mix) for s in done]
    rec = Record(kind="infer", setup_s=t_start - ctx.t0, window_s=t_end - t_start,
                 peak_bytes=peak, crop=mix["cube"], batch=mix["batch"],
                 work={"volumes": len(outs), "voxels": sum(int(np.prod(s)) for s in done),
                       "tiles": sum(t for t, _ in tiles),
                       "tiles_run": sum(t for _, t in tiles), "model": dict(ctx.config)},
                 spans={"dispatch": dispatch})

    log(f"window: {len(outs)} volumes in {t_end - t_start:.3f} s; trits of the first "
        f"(0, 1, 2): {np.bincount(outs[0].ravel(), minlength=3).tolist()}")
    if ctx.trace:
        program.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(SLICE):
                for i in mix["trace_volumes"]:
                    with record_function("portbench.dispatch"):
                        handle = runner.predict_trits_summary_device(vols[i], **kw)
                    with record_function("portbench.fetch_trits"):
                        program.fetch_trits(handle)
                torch.cuda.synchronize()
        rec.trace = Trace.from_profiler(prof, ctx.scratch)
        rec.slice_work = {"tiles_run": sum(_tiles(vols[i].shape, mix)[1]
                                           for i in mix["trace_volumes"]),
                          "launches": dict(program.launch_counts)}
        log("profiled slice read")
    # the check, after the window and the memory peak, on the program's outputs
    del runner
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(ctx.seed)
    others = rng.permutation(np.arange(1, len(outs)))[:max(mix["check_volumes"] - 1, 0)]
    worst = 0.0
    for i in [0, *sorted(int(j) for j in others)]:
        vol = vols[i % len(vols)]
        flips, unit = checked_flips(sd, spec, vol, outs[i], mix, dev)
        worst = max(worst, flips / max(unit, FLOOR_FLIPS))
        log(f"reference of volume {i} {vol.shape}: {flips} trits off, its own bf16 {unit} off")
    return Outcome(attempted=len(outs), failed=0, record=rec,
                   checks=[Check("trit_flips", worst, ctx.limits["trit_flips"])])
