"""Readings that set the Swin UNETR cell's `trit_flips` limit, on the card,
at the cell's own sizes.

    python3 portbench/calibrate_swinunetr.py --seeds 1,2,3 [--volumes 0,1]

For each seed, the program's trits of the mix's volumes (by index in its
cycle) against the plain float32 Swin UNETR's (`reference/swinunetr.py`),
and the reference's own with the inputs of every conv, linear layer and
attention product in bfloat16 (the unit of `trit_flips`) and in float8 e4m3
(the control: the step below the configuration's bfloat16): each one's
flips, and the program's and the control's `trit_flips`. One JSON line a
seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import counts, harness, program  # noqa: E402
from portbench.drivers import infer_stream_swinunetr as drv  # noqa: E402
from portbench.reference import swinunetr as ref  # noqa: E402
from portbench.reference.seunet import no_tf32  # noqa: E402

WORKLOAD = "infer-swinunetr-lungbox"


def infer(conf: dict, mix: dict, seed: int, volumes: list) -> dict:
    dev = torch.device("cuda")
    spec = ref.Spec.from_config(conf)
    sd = ref.make_weights(seed, dev, spec)
    runner = program.SlidingWindowRunner(sd, drv.model_config(conf), cube=mix["cube"],
                                         step=mix["step"], batch=mix["batch"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed % 2**63)
    vols = [counts.phantom(mix["shapes"][i % len(mix["shapes"])], gen, dev)[0]
            for i in range(max(volumes) + 1)]
    kw = dict(h_thresh=mix["h_thresh"], l_thresh=mix["l_thresh"], hu_shift=mix["hu_shift"])
    progs = {i: runner.predict_trits(vols[i], **kw) for i in volumes}
    del runner
    torch.cuda.empty_cache()
    out = {"seed": seed, "volumes": []}
    for i in volumes:
        row = {"index": i, "shape": list(vols[i].shape),
               "trit_counts": np.bincount(progs[i].ravel(), minlength=3).tolist()}
        refs = {}
        for quant in (None, "bf16", "fp8"):
            t = time.perf_counter()
            with no_tf32():
                refs[quant] = ref.predict_trits(
                    sd, vols[i], spec, cube=mix["cube"], step=mix["step"], batch=mix["batch"],
                    h=mix["h_thresh"], l=mix["l_thresh"], hu_shift=mix["hu_shift"], device=dev,
                    quant=quant)
            row[f"ref_{quant or 'f32'}_s"] = time.perf_counter() - t
        flips = {k: int(np.count_nonzero(v != refs[None]))
                 for k, v in (("program", progs[i]), ("bf16", refs["bf16"]),
                              ("fp8", refs["fp8"]))}
        unit = max(flips["bf16"], drv.FLOOR_FLIPS)
        row.update(flips=flips, program=flips["program"] / unit, control=flips["fp8"] / unit)
        out["volumes"].append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--volumes", default="0")
    args = ap.parse_args()
    bench = harness.load_bench()
    work, conf = harness.cell(bench, WORKLOAD)
    config = harness.read_json(harness.ROOT / conf["file"])
    mix = harness.read_json(harness.BENCH / "traffic" / f"{work['traffic']}.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        row = infer(config, mix, seed, [int(v) for v in args.volumes.split(",")])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
