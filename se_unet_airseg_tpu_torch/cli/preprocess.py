"""Preprocessing entry point (reference preprocessing.py:184-192):
BEFORE_DATA/{data,mask} -> AFTER_DATA/{data,mask}. Host code, over the
port's own `pipeline/preprocess.py`.

    python -m se_unet_airseg_tpu_torch.cli.preprocess --input_data BEFORE_DATA/data \\
        --output_data AFTER_DATA/data
"""

from __future__ import annotations

import argparse

from ..pipeline.preprocess import preprocess_ct, preprocess_mask


def main(argv=None):
    p = argparse.ArgumentParser(
        description="CT + mask preprocessing (lung crop, HU clamp)."
    )
    p.add_argument("--input_data", default="BEFORE_DATA/data")
    p.add_argument("--output_data", default="AFTER_DATA/data")
    p.add_argument("--input_mask", default="BEFORE_DATA/mask")
    p.add_argument("--output_mask", default="AFTER_DATA/mask")
    p.add_argument("--mode", default="prepro", choices=("prepro", "prediction"))
    p.add_argument("--skip_mask", action="store_true",
                   help="CT only (no ground-truth masks)")
    a = p.parse_args(argv)

    preprocess_ct(a.input_data, a.output_data, mode=a.mode)
    if not a.skip_mask:
        preprocess_mask(a.input_mask, a.output_mask)
    print(f"preprocessed -> {a.output_data}"
          + ("" if a.skip_mask else f", {a.output_mask}"))


if __name__ == "__main__":
    main()
