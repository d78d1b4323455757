"""Online hard-mining crop cache (reference train.py:78-138).

A loss-sorted, size-bounded directory of .npy crops: filenames encode
the per-crop GUL loss (`"<loss>_<iter>.npy"`), insertion keeps the
list sorted, and when full the LOWEST-loss entry is evicted (so the
cache holds the hardest ~30% of the epoch's crops). Rebuilt from
scratch every epoch (reference train.py:404-414).

A copy of the JAX package's `train/online_cache.py` (same file names,
same eviction). The stage drivers hand `add_batch` the HOST batch and the
per-crop losses fetched once per step, so no crop comes back from the
card.
"""

from __future__ import annotations

import bisect
import os
import shutil

import numpy as np


class OnlineCache:
    def __init__(self, root: str, with_skel: bool = False):
        self.root = root
        self.with_skel = with_skel
        self.subdirs = ["image", "label", "weight"] + (
            ["skel"] if with_skel else []
        )
        self._names: list[str] = []
        self._losses: list[float] = []

    def reset(self):
        """Recreate the cache directories (start of each epoch)."""
        if os.path.exists(self.root):
            shutil.rmtree(self.root)
        for d in self.subdirs:
            os.makedirs(os.path.join(self.root, d))
        self._names, self._losses = [], []

    def _write(self, name: str, arrays: dict):
        np.save(os.path.join(self.root, "image", name), arrays["image"])
        np.save(
            os.path.join(self.root, "label", name),
            arrays["label"].astype(np.int8),
        )
        np.save(os.path.join(self.root, "weight", name), arrays["weight"])
        if self.with_skel:
            np.save(
                os.path.join(self.root, "skel", name),
                arrays["skel"].astype(np.int8),
            )

    def _remove(self, name: str):
        for d in self.subdirs:
            p = os.path.join(self.root, d, name)
            if os.path.exists(p):
                os.remove(p)

    def add_batch(self, batch: dict, per_crop_loss, step: int, limit: int):
        """Insert each crop of a batch keyed by its loss; evict the
        easiest entries beyond `limit`."""
        n = batch["image"].shape[0]
        for i in range(n):
            loss = float(per_crop_loss[i])
            name = f"{loss}_{step}.npy"
            arrays = {k: np.asarray(v[i]) for k, v in batch.items() if k != "name"}
            if len(self._names) < limit:
                self._write(name, arrays)
                idx = bisect.bisect(self._losses, loss)
                self._names.insert(idx, name)
                self._losses.insert(idx, loss)
            else:
                idx = bisect.bisect(self._losses, loss)
                if idx == 0:
                    continue  # easier than everything cached
                self._remove(self._names[0])
                self._names.pop(0)
                self._losses.pop(0)
                self._write(name, arrays)
                idx = bisect.bisect(self._losses, loss)
                self._names.insert(idx, name)
                self._losses.insert(idx, loss)
