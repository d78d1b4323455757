"""Whole CT volumes through the sliding-window runner, one after another.

One client runs volumes back to back (a closed loop), as a test or
validation loop over a case list does. The mix file sets:
  * `shapes`: the (D, H, W) of the volumes, cycled in this order; the first
    is the largest, so the memory peak does not depend on the seed;
  * `volumes`: how many distinct seeded phantoms set-up makes and holds on
    the host (int16, HU + 1024), cycled in the window;
  * `cube`, `step`, `batch`, `h_thresh`, `l_thresh`, `hu_shift`: the runner
    and its thresholds;
  * `warmup`: the volumes run before the window;
  * `trace_volumes`: the volumes of the profiled slice after the window;
  * `check_volumes`: how many volumes of the window the reference predicts
    again (the first, which is the largest, and the rest drawn from the seed).

The window runs `predict_trits` from the stored volume to uint8 trits on
the host, from its first volume's call to its last volume's trits, and ends
with the first volume that completes after `--seconds`. The traced run calls
`predict_trits_summary_device` and `fetch_trits` apart (the two calls
`predict_trits` makes) to time the dispatch.

The check, `trit_flips`: of each checked volume, the voxels whose trit
differs from the plain float32 reference's, over those of the same
reference with its convs computed in bfloat16, the configuration's
precision (at least FLOOR_FLIPS). Random weights put a seed-dependent
share of the voxels near a threshold, where any rounding flips a trit; the
ratio to the reference's own bfloat16 flips measures the program's error
in units of that rounding, so it reads alike from seed to seed. A flip far
from a threshold (a tile left out, a wrong voxel) counts in full.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .. import counts, program
from ..harness import Check, Outcome, Record, log
from ..reference import volume as ref_volume
from ..reference.seunet import no_tf32
from ..reference.spec import make_weights
from ..trace import SLICE, Trace

FLOOR_FLIPS = 1000  # the unit's floor, for volumes whose bf16 reference flips fewer voxels


def _tiles(shape, mix) -> tuple[int, int]:
    """(tiles, tiles after padding to whole batches) of a volume."""
    n = 1
    for e in shape:
        e = max(int(e), mix["cube"])
        rem = (e - mix["cube"]) % mix["step"]
        n *= (e - mix["cube"]) // mix["step"] + (1 if rem == 0 else 2)
    return n, -(-n // mix["batch"]) * mix["batch"]


def run(ctx) -> Outcome:
    mix, dev = ctx.mix, torch.device(ctx.device)
    cfg = program.model_config(ctx.config)
    sd = make_weights(ctx.seed, dev, cfg.in_channels, cfg.side_channels, cfg.n_classes)
    runner = program.SlidingWindowRunner(program.params_from_state_dict(sd), cfg,
                                         cube=mix["cube"], step=mix["step"],
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
                       "tiles_run": sum(t for _, t in tiles)},
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
    with no_tf32():
        for i in [0, *sorted(int(j) for j in others)]:
            vol = vols[i % len(vols)]
            ref, unit = (ref_volume.predict_trits(
                sd, vol, cube=mix["cube"], step=mix["step"], batch=mix["batch"],
                h=mix["h_thresh"], l=mix["l_thresh"], hu_shift=mix["hu_shift"], device=dev,
                quant=quant) for quant in (None, "bf16"))
            flips = int(np.count_nonzero(ref != outs[i]))
            unit = int(np.count_nonzero(ref != unit))
            worst = max(worst, flips / max(unit, FLOOR_FLIPS))
            log(f"reference of volume {i} {vol.shape}: {flips} trits off, its own bf16 "
                f"{unit} off")
    return Outcome(attempted=len(outs), failed=0, record=rec,
                   checks=[Check("trit_flips", worst, ctx.limits["trit_flips"])])
