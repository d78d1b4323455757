"""Dataset split JSON writer/reader (reference write_json.py:11-53,
data.py:14-24). Same on-disk schema:

  base_dict.json: {"0": {"train": [names...], "val": [...]}}
  test.json:      {"test": [names...]}

Names are filenames under AFTER_DATA/mask with extensions stripped of
the trailing '.nii.gz' and 'mask_cut' suffix handling left to callers
(the reference stores e.g. "CASE001" after stripping "mask_cut...").
"""

from __future__ import annotations

import json
import os
import random as _random


def write_split_json(
    mask_dir: str,
    out_dir: str,
    n_train: int | None = None,
    n_val: int | None = None,
    n_test: int | None = None,
    seed: int = 777,
):
    """Shuffle mask files into train/val/test and write both JSONs."""
    files = sorted(os.listdir(mask_dir))
    names = [f.split("mask")[0] for f in files]
    rng = _random.Random(seed)
    rng.shuffle(names)
    n = len(names)
    if n_train is None:
        n_train = int(0.7 * n)
    if n_val is None:
        n_val = int(0.15 * n)
    if n_test is None:
        n_test = n - n_train - n_val
    os.makedirs(out_dir, exist_ok=True)
    base = {"0": {"train": names[:n_train], "val": names[n_train : n_train + n_val]}}
    test = {"test": names[n_train + n_val : n_train + n_val + n_test]}
    with open(os.path.join(out_dir, "base_dict.json"), "w") as f:
        json.dump(base, f)
    with open(os.path.join(out_dir, "test.json"), "w") as f:
        json.dump(test, f)
    return base, test


def load_json_file(file_path: str, folder: str = "0", mode=("train",)) -> list[str]:
    """reference data.py:14-24: folder '0' reads base_dict modes,
    folder '-1' reads the test list; extensions are stripped."""
    with open(file_path) as f:
        data = json.load(f)
    out: list[str] = []
    if folder == "-1":
        entries = data["test"]
    else:
        entries = []
        for m in mode:
            entries += data[folder][m]
    for e in entries:
        out.append(e.split(".nii")[0].split("mask")[0])
    return out
