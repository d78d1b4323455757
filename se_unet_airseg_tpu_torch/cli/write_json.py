"""Split-file writer CLI (reference write_json.py entry point), over the
port's own `data/splits.py`.

    python -m se_unet_airseg_tpu_torch.cli.write_json --mask_dir AFTER_DATA/mask \\
        --out_dir ./data
"""

from __future__ import annotations

import argparse

from ..data.splits import write_split_json


def main(argv=None):
    p = argparse.ArgumentParser(description="Write train/val/test split JSONs.")
    p.add_argument("--mask_dir", default="AFTER_DATA/mask")
    p.add_argument("--out_dir", default="./data")
    p.add_argument("--n_train", type=int, default=None)
    p.add_argument("--n_val", type=int, default=None)
    p.add_argument("--n_test", type=int, default=None)
    p.add_argument("--seed", type=int, default=777)
    a = p.parse_args(argv)
    base, test = write_split_json(
        a.mask_dir, a.out_dir, a.n_train, a.n_val, a.n_test, a.seed
    )
    print(
        f"train {len(base['0']['train'])} / val {len(base['0']['val'])} "
        f"/ test {len(test['test'])} -> {a.out_dir}"
    )


if __name__ == "__main__":
    main()
