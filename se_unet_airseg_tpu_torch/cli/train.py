"""Training entry point (reference train.py:849-917): the full 3-stage
curriculum — stage 1 -> pred_1 -> stage 2 -> best recall epoch ->
pred_2 + break priors -> stage 3 -> DTI re-validation — with the
reference's default on-disk layout.

    python -m se_unet_airseg_tpu_torch.cli.train --data_root AFTER_DATA \\
        --file_root ./data [--epochs 100 50 50] [--device cpu]

The priors the stages read before any prediction exists (LIB weights,
skeletons and parses) come from `pipeline.priors`.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="3-stage curriculum training.")
    p.add_argument("--data_root", default="AFTER_DATA")
    p.add_argument("--file_root", default="./data")
    p.add_argument("--saved_model", default="./saved_model")
    p.add_argument("--log_dir", default="./LOG")
    p.add_argument("--epochs", type=int, nargs=3, default=(100, 50, 50),
                   metavar=("S1", "S2", "S3"))
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--cube", type=int, default=128)
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--no_remat", action="store_true",
                   help="disable per-block rematerialization (needs "
                        "more device memory per crop)")
    p.add_argument("--f32", action="store_true",
                   help="train in float32 (default bfloat16 compute)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    import torch

    from ..models.se_unet import SEUNetConfig
    from ..pipeline.orchestrate import PipelineConfig, run_full_curriculum

    cfg = PipelineConfig(
        data_root=a.data_root,
        file_root=a.file_root,
        saved_model=a.saved_model,
        log_dir=a.log_dir,
        epochs=tuple(a.epochs),
        batch_size=a.batch_size,
        cube=a.cube,
        seed=a.seed,
        model_cfg=SEUNetConfig(
            remat=not a.no_remat,
            compute_dtype=torch.float32 if a.f32 else torch.bfloat16,
        ),
        device=a.device,
    )
    run_full_curriculum(cfg)


if __name__ == "__main__":
    main()
