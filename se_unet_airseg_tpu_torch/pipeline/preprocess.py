"""CT preprocessing: HU normalization, lung-field extraction, crop.

Re-implements the reference's L1 layer (reference preprocessing.py:
26-130 + util.py:58-152) with the same on-disk contract
(SURVEY.md §2.11):

  AFTER_DATA/data/<case>data_cut.nii.gz   cropped CT (stored as HU+1024)
  AFTER_DATA/data/<case>_lung_mask.nii.gz cropped lung mask
  AFTER_DATA/data/<case>_box.npy          6x2 array: crop box rows 0-2,
                                          original shape rows 3-5
  AFTER_DATA/mask/<case>mask_cut.nii.gz   cropped largest-CC GT mask

Behavioral notes preserved deliberately:
  * axis canonicalization heuristics — transpose (1,2,0) when the two
    trailing dims are equal, (0,2,1) when first==last; spacing/origin
    rotation when spacing[0] != spacing[1] (preprocessing.py:34-45);
  * `resolution = [1,1,1]` is declared but NO resampling happens
    (preprocessing.py:28) — volumes keep native spacing;
  * the histogram peak clamp runs on HU+1024 values yet keeps the
    threshold constant at -800 (preprocessing.py:47-71), so after the
    shift it only fires for extreme-valued scans — semantics kept;
  * 'prediction' mode skips lung cropping (preprocessing.py:109-110).

The slice-wise lung-field extraction is vectorized (one thresholded
volume, per-slice 2-D labeling) instead of the reference's
voxel-by-voxel Python loops.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from ..io import read_nifti, write_nifti
from ..post import connected_components, component_counts, fill_holes


def _label_2d8(img2d: np.ndarray) -> tuple[np.ndarray, int]:
    """8-connectivity 2-D labeling via the native 26-conn 3-D labeler
    on a depth-1 volume (raster-order label ids, matching
    scipy.ndimage.label with a ones((3,3)) structure)."""
    labels, n = connected_components(img2d[None], 26)
    return labels[0], n


def load_canonical(path: str):
    """Read a volume with the reference's axis/spacing heuristics
    (reference preprocessing.py:33-45, util.py:11-22)."""
    v = read_nifti(path)
    arr, origin, spacing = v.array, list(v.origin), list(v.spacing)
    if spacing[0] != spacing[1] and spacing[1] == spacing[2]:
        spacing = [spacing[1], spacing[2], spacing[0]]
        origin = [origin[1], origin[2], origin[0]]
    a, b, c = arr.shape
    if b == c:
        arr = arr.transpose(1, 2, 0)
    elif a == c:
        arr = arr.transpose(0, 2, 1)
    return arr, tuple(origin), tuple(spacing)


def clamp_histogram_peaks(pixels: np.ndarray, th: float = -800.0) -> np.ndarray:
    """Clamp extreme-low values to the air peak (reference
    preprocessing.py:47-72). `pixels` is the HU+1024 volume."""
    if pixels.min() > th:
        return pixels
    counts, edges = np.histogram(pixels.reshape(-1), 300)
    start = np.where(edges >= th)[0][0]
    e, c = edges[start:], counts[start:]
    first_peak = e[int(np.argmax(c))]
    dists = np.zeros(300, np.float32)
    n = min(c.shape[0], 299)
    dists[:n] = ((e[1 : n + 1] - first_peak) ** 2) * c[:n]
    second_peak = e[int(np.argmax(dists))]
    fill = min(first_peak, second_peak)
    out = pixels.copy()
    out[out <= th] = fill
    return out


def two_peak_threshold(a: np.ndarray, kmax: int = 300) -> float:
    """Two-peak valley threshold between air and tissue (reference
    util.py:95-117)."""
    counts, edges = np.histogram(a.reshape(-1), kmax)
    counts = counts.copy()
    loc1 = int(np.argmax(counts))
    first_peak = edges[loc1]
    dists = np.zeros(300, np.float32)
    n = min(kmax, counts.shape[0])
    dists[:n] = ((edges[1 : n + 1] - first_peak) ** 2) * counts[:n]
    loc2 = int(np.argmax(dists))
    lo, hi = (loc1, loc2) if loc2 > loc1 else (loc2, loc1)
    peak = counts.max()
    counts[hi:] = peak
    counts[:lo] = peak
    return float(edges[int(np.argmin(counts))])


def lung_fields(array: np.ndarray, threshold: float) -> np.ndarray:
    """Per-slice lung-cavity extraction over the middle 90% of z
    (reference util.py:120-152): threshold -> largest 2-D component
    -> fill-holes XOR (interior cavities) -> keep up to two cavities
    with area > 2000."""
    shape = array.shape
    L = np.zeros(shape, np.uint8)
    above = array >= threshold
    z0, z1 = int(0.05 * shape[2]) - 1, int(0.95 * shape[2])
    for n in range(max(z0, 0), z1):
        lab, nlab = _label_2d8(above[:, :, n])
        if nlab == 0:
            continue
        counts = np.bincount(lab.reshape(-1))
        counts[0] = 0
        body = lab == np.argmax(counts)
        cavities = fill_holes(body).astype(bool) ^ body
        lab2, nlab2 = _label_2d8(cavities)
        if nlab2 == 0:
            continue
        counts2 = np.bincount(lab2.reshape(-1))
        counts2[0] = 0
        first = int(np.argmax(counts2))
        if counts2[first] > 2000:
            L[:, :, n] = lab2 == first
        counts2[first] = 0
        second = int(np.argmax(counts2))
        if counts2[second] > 2000:
            L[:, :, n] |= lab2 == second
    return L


def largest_cc_midslice_fallback(mask: np.ndarray,
                                 probe_z=None) -> np.ndarray:
    """Largest 26-CC, falling back to the 2nd-largest when the largest
    misses all three probe z-slices; fill holes (reference
    util.py:58-75).

    `probe_z` overrides the probe slice indices (default: z//2, z//3,
    z//3*2 of `mask` itself). Callers operating on a bounding-box crop
    must pass the FULL-volume probe slices mapped into crop
    coordinates — the reference always probes the full volume; indices
    outside the crop count as misses (the largest CC cannot intersect
    a plane outside its crop)."""
    labels, n = connected_components(mask.astype(np.uint8), 26)
    if n == 0:
        return np.zeros(mask.shape, np.uint8)
    counts = component_counts(labels, n)
    order = np.argsort(counts, kind="stable")[::-1]
    best = labels == order[0] + 1
    z = mask.shape[2]
    if probe_z is None:
        probe_z = (z // 2, z // 3, z // 3 * 2)
    if n > 1 and not any(
        best[:, :, p].any() for p in probe_z if 0 <= p < z
    ):
        best = labels == order[1] + 1
    return fill_holes(best)


def largest_cc_filled(mask: np.ndarray) -> np.ndarray:
    """Largest 26-CC + fill holes (reference util.py:156-166)."""
    labels, n = connected_components(mask.astype(np.uint8), 26)
    if n == 0:
        return np.zeros(mask.shape, np.uint8)
    counts = component_counts(labels, n)
    best = labels == int(np.argmax(counts)) + 1
    return fill_holes(best)


def preprocess_ct_volume(data_path: str, prep_folder: str, mode: str = "prepro"):
    """savenpy equivalent (reference preprocessing.py:26-113)."""
    name = os.path.basename(data_path).split("data.nii")[0]
    pixels, origin, spacing = load_canonical(data_path)
    pixels = pixels.astype(np.int16) + 1024
    pixels = clamp_histogram_peaks(pixels)

    if mode == "prediction":
        write_nifti(
            os.path.join(prep_folder, name + "data_cut.nii.gz"),
            pixels, spacing, origin,
        )
        return name

    T = two_peak_threshold(pixels)
    L = lung_fields(pixels, T)
    L1 = largest_cc_midslice_fallback(L)
    L2 = largest_cc_midslice_fallback(L ^ L1)
    lung = (L1 + L2).astype(np.uint8)

    xx, yy, zz = np.where(lung)
    box = np.array(
        [[xx.min(), xx.max()], [yy.min(), yy.max()], [zz.min(), zz.max()]]
    )
    margin = 5
    box = np.stack(
        [
            np.maximum(0, box[:, 0] - margin),
            np.minimum(np.array(lung.shape), box[:, 1] + margin),
        ],
        axis=1,
    )

    crop = lambda a: a[box[0, 0]:box[0, 1], box[1, 0]:box[1, 1], box[2, 0]:box[2, 1]]
    write_nifti(
        os.path.join(prep_folder, name + "_lung_mask.nii.gz"),
        crop(lung), spacing, origin,
    )
    shape_rows = np.array([[0, s] for s in pixels.shape])
    np.save(
        os.path.join(prep_folder, name + "_box.npy"),
        np.concatenate([box, shape_rows], axis=0),
    )
    write_nifti(
        os.path.join(prep_folder, name + "data_cut.nii.gz"),
        crop(pixels), spacing, origin,
    )
    return name


def preprocess_mask_volume(data_path: str, prep_folder: str):
    """cutmask equivalent (reference preprocessing.py:115-130)."""
    name = os.path.basename(data_path).split("CASE")[-1].split("mask")[0]
    mask, origin, spacing = load_canonical(data_path)
    box = np.load(
        os.path.join(prep_folder[:-4] + "data", "CASE" + name + "_box.npy"),
        allow_pickle=True,
    )
    mask = largest_cc_filled(mask)
    cut = mask[box[0, 0]:box[0, 1], box[1, 0]:box[1, 1], box[2, 0]:box[2, 1]]
    write_nifti(
        os.path.join(prep_folder, "CASE" + name + "mask_cut.nii.gz"),
        cut.astype(np.uint8), spacing, origin,
    )
    return name


def preprocess_ct(inputpath: str, savepath: str, format: str = "nii.gz",
                  mode: str = "prepro") -> str:
    """Directory driver (reference preprocessing.py:132-164)."""
    os.makedirs(savepath, exist_ok=True)
    if mode == "prepro":
        for f in sorted(glob(os.path.join(inputpath, "*.nii*"))):
            preprocess_ct_volume(f, savepath, mode)
    else:
        preprocess_ct_volume(inputpath, savepath, mode)
    return savepath


def preprocess_mask(inputpath: str, savepath: str) -> str:
    """Directory driver (reference preprocessing.py:166-181)."""
    os.makedirs(savepath, exist_ok=True)
    for f in sorted(glob(os.path.join(inputpath, "*.nii*"))):
        preprocess_mask_volume(f, savepath)
    return savepath
