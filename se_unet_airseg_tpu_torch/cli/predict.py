"""Deployment entry point (reference prediction.py:156-190): for each
case under --ct_dir, preprocess (prediction mode, no lung crop), run
the whole-volume sliding window in EVAL mode, DTI(0.5, 0.4), border
suppression, maximum_3d, save `<case>_pred_mask.nii.gz` + STL.

    python -m se_unet_airseg_tpu_torch.cli.predict --model SE_UNet_43.pt \\
        --ct_dir example_dcm --save_path predicted_airways [--device cpu] \\
        [--arch swin_unetr]

`--model` is the checkpoint, as in the reference's prediction.py; `--arch`
the network it holds.
"""

from __future__ import annotations

import argparse
import os

ARCHS = ("se_unet", "swin_unetr")


def main(argv=None):
    p = argparse.ArgumentParser(description="Clinical airway prediction.")
    p.add_argument("--model", default="./saved_model/stage_three/SE_UNet_43.pt",
                   help=".pt (the port's) or reference .pth checkpoint")
    p.add_argument("--ct_dir", default="example_dcm",
                   help="directory of raw CT volumes (one file per case)")
    p.add_argument("--save_path", default="./predicted_airways/")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--cube", type=int, default=128)
    p.add_argument("--step", type=int, default=64)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--arch", choices=ARCHS, default="se_unet",
                   help="the network: se_unet (default) or swin_unetr (a MONAI SwinUNETR "
                        "state_dict at its published widths)")
    a = p.parse_args(argv)

    import torch

    from ..infer.engine import network_prediction
    from ..train.checkpoint import load_model

    params, cfg = load_model(a.arch, a.model, torch.bfloat16 if a.bf16 else torch.float32)

    cases = sorted(os.listdir(a.ct_dir))
    for case in cases:
        print("ct:", case)
        out = network_prediction(
            params, cfg, os.path.join(a.ct_dir, case), a.save_path,
            cube=a.cube, step=a.step, device=a.device,
        )
        print(" ->", out)


if __name__ == "__main__":
    main()
