"""Readings that set a cell's limits, on the card, at the cell's own sizes.

    python3 portbench/calibrate.py infer --workload <name> --seeds 1,2,3 [--volumes 0,1]
    python3 portbench/calibrate.py train --workload <name> --seeds 1,2,3

`infer`: for each seed, the program's trits of the mix's volumes (by index
in its cycle) against the plain float32 reference's, and the reference's
own in bfloat16 (the unit of the cell's `trit_flips`) and in float8 e4m3
(the control: the step below the configuration's bfloat16): each one's
flips, and the program's and the control's `trit_flips`. `train`: for each
seed, on the cell's first batches (always the resident pool's cut, the
same step and sizes), the program's checked steps, the reference's in
bfloat16, the control (the reference in float8 in the program's place)
and one fault (half of each batch left out), each against the float32
reference: every number the train driver computes, with where it was
read. A state left unchanged reads 1 on `change_gap_median` by its
definition and needs no run. One JSON line a seed; the benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import counts, harness, program  # noqa: E402
from portbench.drivers import infer_stream, train_stage1  # noqa: E402
from portbench.reference import volume as ref_volume  # noqa: E402
from portbench.reference.seunet import no_tf32  # noqa: E402
from portbench.reference.spec import make_weights  # noqa: E402


def infer(ctx, seed: int, volumes: list) -> dict:
    mix, dev = ctx.mix, torch.device("cuda")
    cfg = program.model_config(ctx.config)
    sd = make_weights(seed, dev, cfg.in_channels, cfg.side_channels, cfg.n_classes)
    runner = program.SlidingWindowRunner(program.params_from_state_dict(sd), cfg,
                                         cube=mix["cube"], step=mix["step"],
                                         batch=mix["batch"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(h_thresh=mix["h_thresh"], l_thresh=mix["l_thresh"], hu_shift=mix["hu_shift"])
    out = {"seed": seed, "volumes": []}
    vols = [counts.phantom(mix["shapes"][i % len(mix["shapes"])], gen, dev)[0]
            for i in range(max(volumes) + 1)]
    progs = {i: runner.predict_trits(vols[i], **kw) for i in volumes}
    del runner
    torch.cuda.empty_cache()
    for i in volumes:
        row = {"index": i, "shape": list(vols[i].shape),
               "trit_counts": np.bincount(progs[i].ravel(), minlength=3).tolist()}
        refs = {}
        for quant in (None, "bf16", "fp8"):
            t = time.perf_counter()
            with no_tf32():
                refs[quant] = ref_volume.predict_trits(
                    sd, vols[i], cube=mix["cube"], step=mix["step"], batch=mix["batch"],
                    h=mix["h_thresh"], l=mix["l_thresh"], hu_shift=mix["hu_shift"],
                    device=dev, quant=quant)
            row[f"ref_{quant or 'f32'}_s"] = time.perf_counter() - t
        flips = {k: int(np.count_nonzero(v != refs[None]))
                 for k, v in (("program", progs[i]), ("bf16", refs["bf16"]),
                              ("fp8", refs["fp8"]))}
        unit = max(flips["bf16"], infer_stream.FLOOR_FLIPS)
        row.update(flips=flips, program=flips["program"] / unit, control=flips["fp8"] / unit)
        out["volumes"].append(row)
    return out


def train(ctx, seed: int) -> dict:
    mix, dev = ctx.mix, torch.device("cuda")
    ctx.seed = seed
    cfg = program.model_config(ctx.config)
    sd = make_weights(seed, dev, cfg.in_channels, cfg.side_channels, cfg.n_classes)
    draws = train_stage1.Draws(seed, dev, cfg.side_channels)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = train_stage1._cases(ctx, gen, dev)
    batches = train_stage1._resident_pool(ctx, cases)[:train_stage1.CHECKED_STEPS]
    prog = train_stage1.Program(cfg, mix, sd, draws, dev)
    losses, grad1, theta, _ = prog.checked_steps(iter(batches))
    theta0, prog = prog.theta0, None
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = train_stage1.reference_steps(sd, batches, draws.kept, dev)
    out = {"seed": seed, "reference_s": time.perf_counter() - t, "losses": ref[0]}
    t = time.perf_counter()
    unit = train_stage1.numbers(sd, sd, *train_stage1.reference_steps(
        sd, batches, draws.kept, dev, quant="bf16"), ref)
    out.update(bf16=unit, bf16_s=time.perf_counter() - t,
               program=train_stage1.numbers(sd, theta0, losses, grad1, theta, ref, unit))
    for name, kw in (("control", {"quant": "fp8"}),
                     ("half_batch", {"rows": slice(0, mix["batch"] // 2)})):
        t = time.perf_counter()
        got = train_stage1.reference_steps(sd, batches, draws.kept, dev, **kw)
        out[name] = train_stage1.numbers(sd, sd, *got, ref, unit)
        out[name + "_s"] = time.perf_counter() - t
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("infer", "train"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--volumes", default="0")
    args = ap.parse_args()
    bench = harness.load_bench()
    work, conf = harness.cell(bench, args.workload)
    ctx = harness.Context(
        workload=args.workload, seed=0, seconds=0.0, trace=False,
        config=harness.read_json(harness.ROOT / conf["file"]),
        mix=harness.read_json(harness.BENCH / "traffic" / f"{work['traffic']}.json"),
        limits={}, t0=time.perf_counter(), scratch=tempfile.gettempdir())
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.mode == "infer":
            row = infer(ctx, seed, [int(v) for v in args.volumes.split(",")])
        else:
            row = train(ctx, seed)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
