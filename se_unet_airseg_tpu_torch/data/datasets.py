"""Host-side crop pipelines for the 3-stage curriculum.

The reference's convention — one Dataset item = one VOLUME yielding a
whole batch of `batch_size` crops (reference data.py:254-715,
SURVEY.md §2.5) — is kept: each epoch iterates volumes, and each
volume contributes `batch_size` crops forming one device batch.
Torch DataLoader workers are replaced with a thread prefetcher
(`Prefetcher`) that crops the next volume while the card runs a step.

Under a profiler session (`utils.profiling`) each volume's batch is a
`data.batch` span with its parts under it: `data.read` (the NIfTI and
.npy files read and decompressed), `data.augment` (each crop cut, flipped
and rotated) and `data.finalize` (each crop's windows and LIB power, and
the stacking); the consumer's wait on the Prefetcher is `data.wait`.

Batches are dicts of numpy arrays in the train-step format (the stage
drivers upload a copy per step and keep the host arrays for the online
hard-mining cache):
  image  (B, c, c, c, 2) float32 — dual-windowed
  label  (B, c, c, c)    float32
  weight (B, c, c, c)    float32   (stages 2/3)
  skel   (B, c, c, c)    float32   (stage 3)

A copy of the JAX package's `data/datasets.py`: the same files, draws
and crops, so both packages yield equal batches from the same seed.
One difference: the JAX `Prefetcher` ends the epoch early and silently
when its thread raises; this one raises the thread's exception in the
consumer.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

from ..io import read_nifti
from ..utils.profiling import span
from .augment import augment_crops
from .samplers import (
    centered_random_crop,
    hard_sample,
    location_crop,
    point_crop,
    random_crop,
    small_airway_sampler,
)
from .splits import load_json_file


def _window_pair(hu: np.ndarray):
    """The dual HU windows (reference data.py:286-299)."""
    a = np.clip(hu, -1024, 1024).astype(np.float32)
    a = (a + 1024) / 2048
    b = np.clip(hu, -1000, 500).astype(np.float32)
    b = (b + 1000) / 1500
    return a, b


def _load_volume(data_root: str, name: str):
    """CT in raw HU (float32) + binary label (uint8). Windowing and
    float casts happen per CROP, not per volume — the host does
    cube^3-sized work per sample instead of full-volume passes."""
    with span("data.read"):
        img = read_nifti(os.path.join(data_root, "data", name + "data_cut.nii.gz"))
        hu = img.array.astype(np.float32) - 1024.0
        label = read_nifti(
            os.path.join(data_root, "mask", name + "mask_cut.nii.gz")
        ).array
        label = (label > 0).astype(np.uint8)
    return hu, label


def _load_npy(path: str) -> np.ndarray:
    with span("data.read"):
        return np.load(path)


def _read_array(path: str) -> np.ndarray:
    with span("data.read"):
        return read_nifti(path).array


def _powered_weight(lib_weight, label, expo):
    """weight ** (U[0,1)+2) * label + (1-label) (reference data.py:386,
    568, 701) — the random power is drawn per VOLUME per epoch."""
    w = lib_weight.astype(np.float32)
    lab = label.astype(np.float32)
    return w ** expo * lab + (1.0 - lab)


def _finalize_crop(c: dict, expo: float) -> dict:
    """Per-crop deferred work: dual windowing of the HU crop and the
    random-power LIB weight (identical values to the reference's
    full-volume formulation — windowing and pow are pointwise and
    commute with crop/flip/rotate)."""
    with span("data.finalize"):
        img, img2 = _window_pair(c.pop("hu"))
        c["img"], c["img2"] = img, img2
        if "lib" in c:
            c["weight"] = _powered_weight(c.pop("lib"), c["label"], expo)
    return c


def _to_batch(crops: list[dict]) -> dict:
    with span("data.finalize"):
        keys = crops[0].keys()
        out = {}
        for k in keys:
            arr = np.stack([c[k] for c in crops]).astype(np.float32)
            out[k] = arr
        if "img" in out and "img2" in out:
            out["image"] = np.stack([out.pop("img"), out.pop("img2")], axis=-1)
    return out


def _crop_batch(pick, n: int, aug: bool, rng, expo: float) -> dict:
    """`n` crops, each cut by `pick()` and, with `aug`, flipped and
    rotated, then finalized and stacked into one batch."""
    crops = []
    for _ in range(n):
        with span("data.augment"):
            c = pick()
            if aug:
                vals = augment_crops(list(c.values()), rng)
                c = dict(zip(c.keys(), vals))
        crops.append(_finalize_crop(c, expo))
    return _to_batch(crops)


class _VolumeBatches:
    """One batch of crops per training volume, the volumes in an order
    drawn per epoch."""

    def __len__(self):
        return len(self.names)

    def __iter__(self):
        order = self.rng.permutation(len(self.names))
        for i in order:
            with span("data.batch"):
                batch = self.sample_volume(self.names[i])
            yield batch


class Stage1Crops(_VolumeBatches):
    """Uniform random crops + LIB weights (reference CropSegData,
    data.py:632-715)."""

    def __init__(self, file_path, data_root, file_root, batch_size=8,
                 cube=128, aug=True, seed=777, mode=("train",)):
        self.names = load_json_file(file_path, "0", mode)
        self.data_root, self.file_root = data_root, file_root
        self.batch_size, self.cube, self.aug = batch_size, cube, aug
        self.rng = np.random.default_rng(seed)

    def sample_volume(self, name: str) -> dict:
        hu, label = _load_volume(self.data_root, name)
        lib = _load_npy(os.path.join(self.file_root, "LIB_weight", name + ".npy"))
        expo = self.rng.random() + 2.0
        vols = {"hu": hu, "label": label, "lib": lib}
        batch = _crop_batch(lambda: centered_random_crop(vols, self.cube, self.rng),
                            self.batch_size, self.aug, self.rng, expo)
        batch["name"] = name
        return batch


class Stage2Crops(_VolumeBatches):
    """Hard-mining crops guided by stage-1 misses (reference
    AirwayHMData, data.py:254-408). `hard_ratio` is owned by the
    CurriculumScheduler and set by the stage driver each epoch."""

    def __init__(self, file_path, data_root, file_root, pred_path,
                 batch_size=8, cube=128, aug=True, seed=777):
        self.names = load_json_file(file_path, "0", ("train",))
        self.data_root, self.file_root = data_root, file_root
        self.pred_path = pred_path
        self.batch_size, self.cube, self.aug = batch_size, cube, aug
        self.rng = np.random.default_rng(seed)
        self.hard_ratio = 0.4  # reference data.py:273-281

    def _load_priors(self, name):
        pred = _read_array(os.path.join(self.pred_path, name + ".nii.gz"))
        if pred.ndim > 3:
            pred = pred[0]
        skel = _read_array(os.path.join(self.file_root, "skeleton", name + "mask_cut.nii.gz"))
        return (pred > 0).astype(np.uint8), (skel > 0).astype(np.uint8)

    def sample_volume(self, name: str) -> dict:
        hu, label = _load_volume(self.data_root, name)
        lib = _load_npy(os.path.join(self.file_root, "LIB_weight", name + ".npy"))
        expo = self.rng.random() + 2.0
        pred1, skel = self._load_priors(name)

        # "small airway" set {EDT(label)·skel < 2} sampled lazily
        # (bug-compatible with reference data.py:305 — see
        # samplers.small_airway_sampler); skeleton-miss set is sparse,
        # so materialize it.
        loc_small = small_airway_sampler(label, skel, self.rng)
        loc_skeleton = np.where((skel != 0) & (pred1 == 0))

        vols = {"hu": hu, "label": label, "lib": lib}

        def pick():
            if self.rng.random() < self.hard_ratio:
                return hard_sample(vols, loc_skeleton, loc_small, self.cube, self.rng)
            return random_crop(vols, self.cube, self.rng)

        batch = _crop_batch(pick, self.batch_size, self.aug, self.rng, expo)
        batch["name"] = name
        return batch


class Stage3Crops(_VolumeBatches):
    """Break-point-guided crops (reference AirwayHMData3,
    data.py:410-584): weight = LIB + 0.6*BR, extra skeleton channel,
    break/skeleton/small/random sampling mix."""

    def __init__(self, file_path, data_root, file_root, pred2_path,
                 br_skel_path, br_weight_path, batch_size=8, cube=128,
                 aug=True, seed=777):
        self.names = load_json_file(file_path, "0", ("train",))
        self.data_root, self.file_root = data_root, file_root
        self.pred2_path = pred2_path
        self.br_skel_path = br_skel_path
        self.br_weight_path = br_weight_path
        self.batch_size, self.cube, self.aug = batch_size, cube, aug
        self.rng = np.random.default_rng(seed)
        self.hard_ratio = 0.8  # reference data.py:422-429
        self.break_ratio = 0.625

    def sample_volume(self, name: str) -> dict:
        hu, label = _load_volume(self.data_root, name)
        lib = _load_npy(os.path.join(self.file_root, "LIB_weight", name + ".npy"))
        br_w = _load_npy(os.path.join(self.br_weight_path, name + ".npy"))
        lib_mix = lib.astype(np.float32) + 0.6 * br_w.astype(np.float32)
        expo = self.rng.random() + 2.0
        br_skel = _load_npy(os.path.join(self.br_skel_path, name + ".npy"))
        pred2 = _read_array(os.path.join(self.pred2_path, name + ".nii.gz"))
        if pred2.ndim > 3:
            pred2 = pred2[0]
        skel = _read_array(os.path.join(self.file_root, "skeleton", name + "mask_cut.nii.gz"))
        skel = (skel > 0).astype(np.uint8)

        loc_small = small_airway_sampler(label, skel, self.rng)  # see Stage2
        loc_skeleton = np.where((skel != 0) & (pred2 == 0))
        loc_break = tuple(br_skel)

        vols = {"hu": hu, "label": label, "lib": lib_mix, "skel": skel}

        def pick():
            if self.rng.random() < self.hard_ratio:
                if self.rng.random() < self.break_ratio and len(loc_break[0]) != 0:
                    return location_crop(vols, loc_break, self.cube, self.rng)
                if self.rng.random() < 0.5 and (p := loc_small()) is not None:
                    return point_crop(vols, p, self.cube, self.rng)
                if len(loc_skeleton[0]) != 0:
                    return location_crop(vols, loc_skeleton, self.cube, self.rng)
            return random_crop(vols, self.cube, self.rng)

        batch = _crop_batch(pick, self.batch_size, self.aug, self.rng, expo)
        batch["name"] = name
        return batch


class OnlineCrops:
    """Replay of the hardest cached crops (reference OnlineHMData[3],
    data.py:586-630): top `rate` fraction by the loss encoded in the
    filename `<loss>_<iter>.npy`."""

    def __init__(self, cache_root: str, rate: float = 0.33, with_skel=False,
                 shuffle_rng=None):
        self.root = cache_root
        self.with_skel = with_skel
        names = os.listdir(os.path.join(cache_root, "image"))
        names.sort(key=lambda x: float(x.split("_")[0]))
        self.names = names[-int(rate * len(names)):] if names else []
        if shuffle_rng is not None:
            # the reference replays in SHUFFLED order
            # (DataLoader(shuffle=True), train.py:474)
            shuffle_rng.shuffle(self.names)

    def __len__(self):
        return len(self.names)

    def __iter__(self):
        for name in self.names:
            out = {
                "image": np.load(os.path.join(self.root, "image", name)),
                "label": np.load(os.path.join(self.root, "label", name)).astype(np.float32),
                "weight": np.load(os.path.join(self.root, "weight", name)),
            }
            if self.with_skel:
                out["skel"] = np.load(
                    os.path.join(self.root, "skel", name)
                ).astype(np.float32)
            out["name"] = name
            yield out


class Prefetcher:
    """Thread-backed prefetch of the next volume batches (replaces
    torch DataLoader(num_workers=10), reference train.py:549-554). An
    exception raised while the thread produces a batch is raised again
    in the consumer once the batches before it are consumed: a silently
    short epoch would hide the failure."""

    _END = object()

    def __init__(self, iterable, depth: int = 2):
        self.it = iter(iterable)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.error: Exception | None = None
        self.thread = threading.Thread(target=self._fill, daemon=True, name="Prefetcher")
        self.thread.start()

    def _fill(self):
        try:
            for item in self.it:
                self.q.put(item)
        except Exception as e:  # handed to the consumer, which raises it
            self.error = e
        finally:
            self.q.put(self._END)

    def __iter__(self):
        while True:
            with span("data.wait"):
                item = self.q.get()
            if item is self._END:
                if self.error is not None:
                    raise self.error
                return
            yield item
