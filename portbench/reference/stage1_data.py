"""Plain stage-1 training data: the case files on disk, the LIB weight,
and the crops, augmentations and windows of one volume's batch.

A plain copy of the published data path (reference data.py:40-73, 286-299,
632-715, lib_weight.py:12-53): one volume gives one batch of crops whose
centres are drawn uniformly in [cube/2, extent - cube/2]; each crop is
flipped (never the identity) with p 0.5, then turned a quarter left or
right with p 0.5; the CT is cut to two HU windows, and the LIB weight is
raised to a power U[0, 1) + 2 drawn once per volume, inside the label and
1 outside. The draws come from one numpy Generator in this order: the
volume order of an epoch, then per volume the power, then per crop the
three centres and the augmentation's draws.

The files are single-file NIfTI-1, gzip-compressed, (z, y, x) order, as
the published preprocessing writes them.
"""

from __future__ import annotations

import gzip
import json
import os
import struct

import numpy as np
import torch
import torch.nn.functional as F

_NIFTI_CODES = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.float32): 16}
_NIFTI_DTYPES = {v: k for k, v in _NIFTI_CODES.items()}


def write_nifti_gz(path: str, array: np.ndarray, level: int = 1) -> None:
    """A (z, y, x) array as a gzip NIfTI-1 file with a unit sform."""
    arr = np.ascontiguousarray(array)
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *arr.shape[::-1], 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, _NIFTI_CODES[arr.dtype])
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)
    struct.pack_into("<2h", hdr, 252, 0, 1)
    struct.pack_into("<12f", hdr, 280, -1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 0)
    hdr[344:348] = b"n+1\x00"
    with open(path, "wb") as f, gzip.GzipFile(filename="", fileobj=f, mode="wb",
                                             compresslevel=level, mtime=0) as gz:
        gz.write(bytes(hdr))
        gz.write(arr.tobytes())


def read_nifti_gz(path: str) -> np.ndarray:
    """The (z, y, x) array of a gzip NIfTI-1 file written as above."""
    with gzip.open(path, "rb") as f:
        raw = f.read()
    dim = struct.unpack_from("<8h", raw, 40)
    dtype = _NIFTI_DTYPES[struct.unpack_from("<h", raw, 70)[0]]
    offset = int(struct.unpack_from("<f", raw, 108)[0])
    shape = dim[1:1 + dim[0]][::-1]
    return np.frombuffer(raw, dtype, int(np.prod(shape)), offset).reshape(shape)


def lib_weight(label: torch.Tensor) -> torch.Tensor:
    """-log10 of the label's local density in a 7^3 box (mirror padding; a
    density of 0 counts as 1), times the label; float32."""
    x = label.to(torch.float32)
    xp = F.pad(x[None, None], (3,) * 6, mode="reflect")
    dens = F.avg_pool3d(xp, 7, stride=1, divisor_override=1)[0, 0] / 343.0
    dens = torch.where(dens == 0.0, torch.ones_like(dens), dens)
    return -torch.log10(dens) * x


def write_case(root: str, name: str, stored: np.ndarray, label: np.ndarray,
               lib: np.ndarray) -> None:
    """One case in the training layout: data/<n>data_cut.nii.gz (int16
    HU + 1024), mask/<n>mask_cut.nii.gz (uint8), LIB_weight/<n>.npy
    (float16)."""
    for sub in ("data", "mask", "LIB_weight"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    write_nifti_gz(os.path.join(root, "data", f"{name}data_cut.nii.gz"), stored)
    write_nifti_gz(os.path.join(root, "mask", f"{name}mask_cut.nii.gz"), label)
    np.save(os.path.join(root, "LIB_weight", f"{name}.npy"), lib.astype(np.float16))


def write_split(path: str, names: list[str]) -> None:
    with open(path, "w") as f:
        json.dump({"0": {"train": list(names), "val": []}}, f)


def read_case(root: str, name: str):
    """(HU float32, label uint8 0/1, LIB float16) of one case."""
    hu = read_nifti_gz(os.path.join(root, "data", f"{name}data_cut.nii.gz"))
    label = read_nifti_gz(os.path.join(root, "mask", f"{name}mask_cut.nii.gz"))
    lib = np.load(os.path.join(root, "LIB_weight", f"{name}.npy"))
    return hu.astype(np.float32) - 1024.0, (label > 0).astype(np.uint8), lib


def _flip(arrays, rng):
    f = rng.integers(0, 2, 3) * 2 - 1
    while (f == 1).all():
        f = rng.integers(0, 2, 3) * 2 - 1
    return [np.ascontiguousarray(a[::f[0], ::f[1], ::f[2]]) for a in arrays]


def _turn(arrays, rng):
    if rng.random() > 0.5:  # left
        return [np.ascontiguousarray(np.ascontiguousarray(a.transpose(0, 2, 1))[:, ::-1])
                for a in arrays]
    out = []
    for a in arrays:  # right
        a = np.ascontiguousarray(a[:, ::-1]).transpose(0, 2, 1)
        out.append(np.ascontiguousarray(a[:, ::-1]))
    return out


def _windows(hu):
    a = (np.clip(hu, -1024, 1024).astype(np.float32) + 1024) / 2048
    b = (np.clip(hu, -1000, 500).astype(np.float32) + 1000) / 1500
    return a, b


def volume_batch(hu, label, lib, rng, batch: int, cube: int, aug: bool = True) -> dict:
    """One volume's batch: image (B, c, c, c, 2), label and weight (B, c, c, c),
    float32."""
    expo = rng.random() + 2.0
    img, img2, lab, wt = [], [], [], []
    for _ in range(batch):
        start = [int(rng.integers(cube // 2, hu.shape[i] - cube // 2 + 1)) - cube // 2
                 for i in range(3)]
        cut = tuple(slice(s, s + cube) for s in start)
        arrays = [hu[cut], label[cut], lib[cut]]
        if aug:
            if rng.random() > 0.5:
                arrays = _flip(arrays, rng)
            if rng.random() > 0.5:
                arrays = _turn(arrays, rng)
        h, l, w = arrays
        a, b = _windows(h)
        img.append(a)
        img2.append(b)
        lf = l.astype(np.float32)
        lab.append(l)
        wt.append(w.astype(np.float32) ** expo * lf + (1.0 - lf))
    return {"image": np.stack([np.stack(img).astype(np.float32),
                               np.stack(img2).astype(np.float32)], axis=-1),
            "label": np.stack(lab).astype(np.float32),
            "weight": np.stack(wt).astype(np.float32)}


def epoch_batches(root: str, names: list[str], rng, batch: int, cube: int, count: int):
    """The first `count` batches of the epochs that `rng` draws over the
    cases `names` (each epoch a permutation of them)."""
    out = []
    while len(out) < count:
        for i in rng.permutation(len(names)):
            if len(out) == count:
                break
            out.append(volume_batch(*read_case(root, names[i]), rng, batch, cube))
    return out
