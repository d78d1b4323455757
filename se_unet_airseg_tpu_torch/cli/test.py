"""Test entry point (reference test.py:272-297): pick the best
stage-three epoch from the LOG (mean of TD/BD/DSC/Pre — reference
test.py:44-65), then run the full test flow (sliding window, DTI
0.5/0.35, border suppression, maximum_3d, nii.gz output, metric
aggregate + boxplot) over ./data/test.json.

    python -m se_unet_airseg_tpu_torch.cli.test --data_root AFTER_DATA \\
        --file_path data/test.json --file_root data [--params SE_UNet_43.pt] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Test-set evaluation.")
    p.add_argument("--data_root", default="AFTER_DATA")
    p.add_argument("--file_path", default="./data/test.json")
    p.add_argument("--file_root", default="./data")
    p.add_argument("--log_path", default="./LOG/log_stage_three.txt")
    p.add_argument("--model_dir", default="./saved_model/stage_three")
    p.add_argument("--result_savepath", default="./test_result")
    p.add_argument("--testlog_savepath", default="./LOG/testlog_stage_three.txt")
    p.add_argument("--stage_name", default="stage_three")
    p.add_argument("--epoch", type=int, default=None,
                   help="override best-epoch LOG selection")
    p.add_argument("--params", default=None,
                   help="explicit checkpoint (.pt, the port's, or reference .pth), "
                        "bypassing model_dir/epoch")
    p.add_argument("--no_dti", action="store_true")
    p.add_argument("--cube", type=int, default=128)
    p.add_argument("--step", type=int, default=64)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    import torch

    from ..data.splits import load_json_file
    from ..infer.engine import run_test
    from ..models.se_unet import SEUNetConfig
    from ..train.checkpoint import load_params
    from ..train.logbook import best_epoch_test

    if a.params:
        path = a.params
    else:
        ep = a.epoch if a.epoch is not None else best_epoch_test(a.log_path)
        path = os.path.join(a.model_dir, f"SE_UNet_{ep}.pt")
        print(f"best epoch: {ep} -> {path}")
    params = load_params(path)

    cfg = SEUNetConfig(compute_dtype=torch.bfloat16 if a.bf16 else torch.float32)
    names = load_json_file(a.file_path, "-1")
    os.makedirs(os.path.dirname(a.testlog_savepath) or ".", exist_ok=True)
    run_test(
        params, cfg, names, a.data_root, a.file_root,
        a.testlog_savepath, a.result_savepath,
        stage_name=a.stage_name, dti=not a.no_dti,
        cube=a.cube, step=a.step, device=a.device,
    )


if __name__ == "__main__":
    main()
