"""ctypes bindings for the native post-processing library.

The library is the repository's `csrc/airseg_post.cpp`, compiled with the
host C++ compiler (`$CXX`, default `g++`) at first use into the
git-ignored `se_unet_airseg_tpu_torch/csrc/build/`, named by the
source's hash (an edited source builds anew). Where it cannot be built
or loaded, each function falls back to its scipy equivalent where one
exists; skeletonization has none and raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "airseg_post.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"


def _build() -> Path:
    """Compile the source once per content hash; returns the library's
    path. Builds in a temporary directory, then renames, so a concurrent
    build never loads a half-written file."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    path = _BUILD_DIR / f"libairseg_post_{tag}.so"
    if path.exists():
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        so = Path(tmp) / path.name
        subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-o", str(so),
                        str(_SRC)], check=True, capture_output=True)
        os.replace(so, path)
    return path


@functools.cache
def _load():
    """The loaded library, or None where it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.CalledProcessError):
        return None
    i64, u8p, u32p, f32p, i32p, i64p = (
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
        np.ctypeslib.ndpointer(np.uint32, flags="C"),
        np.ctypeslib.ndpointer(np.float32, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
    )
    lib.cc3d_label.restype = i64
    lib.cc3d_label.argtypes = [u8p, i64, i64, i64, ctypes.c_int, u32p]
    lib.cc3d_counts.restype = None
    lib.cc3d_counts.argtypes = [u32p, i64, i64, i64p]
    lib.dti_sweep.restype = None
    lib.dti_sweep.argtypes = [f32p, i64, i64, i64, ctypes.c_float, ctypes.c_float, u8p]
    lib.skeletonize3d.restype = None
    lib.skeletonize3d.argtypes = [u8p, i64, i64, i64]
    lib.fill_holes.restype = None
    lib.fill_holes.argtypes = [u8p, i64, i64, i64, ctypes.c_int, u8p]
    lib.edt_sq.restype = None
    lib.edt_sq.argtypes = [u8p, i64, i64, i64, f32p, ctypes.c_void_p]
    for name in ("binary_dilate6", "binary_erode6"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [u8p, i64, i64, i64, u8p]
    lib.box_convolve27.restype = None
    lib.box_convolve27.argtypes = [f32p, i64, i64, i64, f32p]
    lib.label_bboxes.restype = None
    lib.label_bboxes.argtypes = [i32p, i64, i64, i64, i64, i64p]
    lib.march_tets.restype = ctypes.c_int64
    lib.march_tets.argtypes = [f32p, i64, i64, i64, ctypes.c_float, ctypes.c_void_p, i64]
    return lib


def native_available() -> bool:
    return _load() is not None


def connected_components(mask: np.ndarray, connectivity: int = 26) -> tuple[np.ndarray, int]:
    """Label foreground components; returns (labels uint32, n)."""
    m = np.ascontiguousarray(mask != 0).astype(np.uint8)
    lib = _load()
    if lib is not None:
        out = np.zeros(m.shape, np.uint32)
        n = lib.cc3d_label(m, *m.shape, connectivity, out)
        return out, int(n)
    from scipy import ndimage

    structure = np.ones((3, 3, 3)) if connectivity == 26 else None
    lab, n = ndimage.label(m, structure=structure)
    return lab.astype(np.uint32), int(n)


def component_counts(labels: np.ndarray, n: int) -> np.ndarray:
    lib = _load()
    if lib is not None and labels.dtype == np.uint32:
        counts = np.zeros(n, np.int64)
        lib.cc3d_counts(np.ascontiguousarray(labels), labels.size, n, counts)
        return counts
    return np.bincount(labels.reshape(-1), minlength=n + 1)[1:].astype(np.int64)


def largest_component(mask: np.ndarray, connectivity: int = 26) -> np.ndarray:
    """Binary mask of the largest connected component (empty-safe)."""
    labels, n = connected_components(mask, connectivity)
    if n == 0:
        return np.zeros(mask.shape, np.uint8)
    counts = component_counts(labels, n)
    return (labels == (int(np.argmax(counts)) + 1)).astype(np.uint8)


def dti(pred: np.ndarray, h_thresh: float = 0.5, l_thresh: float = 0.4) -> np.ndarray:
    """Double-threshold iteration, exact reference semantics
    (reference train.py:25-49: one raster sweep with in-place
    propagation and clamped 26-neighbor lookups)."""
    p = np.ascontiguousarray(pred, np.float32)
    lib = _load()
    if lib is not None:
        out = np.zeros(p.shape, np.uint8)
        lib.dti_sweep(p, *p.shape, h_thresh, l_thresh, out)
        return out
    return _dti_python(p, h_thresh, l_thresh)


def _dti_python(pred: np.ndarray, h_thresh: float, l_thresh: float) -> np.ndarray:
    """Slow exact fallback (same raster-sweep semantics)."""
    p = pred * 255.0
    hi, lo = h_thresh * 255.0, l_thresh * 255.0
    out = (p >= hi).astype(np.uint8)
    d, h, w = p.shape
    band = (p >= lo) & (p < hi)
    for z, y, x in zip(*np.nonzero(band)):
        if out[z, y, x]:
            continue
        z0, z1 = max(z - 1, 0), min(z + 1, d - 1)
        y0, y1 = max(y - 1, 0), min(y + 1, h - 1)
        x0, x1 = max(x - 1, 0), min(x + 1, w - 1)
        if out[z0 : z1 + 1, y0 : y1 + 1, x0 : x1 + 1].any():
            out[z, y, x] = 1
    return out


def skeletonize_3d(mask: np.ndarray) -> np.ndarray:
    """Curve-skeleton by directional thinning (native only)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"skeletonize_3d requires the native library, built from {_SRC.name} "
            "with the host C++ compiler"
        )
    img = np.ascontiguousarray(mask != 0).astype(np.uint8)
    lib.skeletonize3d(img, *img.shape)
    return img


def fill_holes(mask: np.ndarray) -> np.ndarray:
    """Fill interior holes (background not face-connected to the
    border), matching scipy.ndimage.binary_fill_holes with the default
    conn-1 structure. Accepts 2-D or 3-D input; returns uint8."""
    m = np.ascontiguousarray(mask != 0).astype(np.uint8)
    squeeze = m.ndim == 2
    if squeeze:
        m = m[None]
    lib = _load()
    if lib is not None:
        out = np.empty_like(m)
        lib.fill_holes(m, *m.shape, 0 if squeeze else 1, out)
    else:
        from scipy import ndimage

        out = ndimage.binary_fill_holes(m).astype(np.uint8)
    return out[0] if squeeze else out


def binary_dilation(mask: np.ndarray) -> np.ndarray:
    """One binary dilation with scipy's default conn-1 (6-neighborhood)
    structure; 3-D uint8 out."""
    m = np.ascontiguousarray(mask != 0).astype(np.uint8)
    lib = _load()
    if lib is not None:
        out = np.empty_like(m)
        lib.binary_dilate6(m, *m.shape, out)
        return out
    from scipy import ndimage

    return ndimage.binary_dilation(m).astype(np.uint8)


def binary_closing(mask: np.ndarray) -> np.ndarray:
    """Binary closing (dilation then erosion), scipy defaults: conn-1
    structure, border_value=0 on both passes."""
    m = np.ascontiguousarray(mask != 0).astype(np.uint8)
    lib = _load()
    if lib is not None:
        tmp = np.empty_like(m)
        lib.binary_dilate6(m, *m.shape, tmp)
        out = np.empty_like(m)
        lib.binary_erode6(tmp, *m.shape, out)
        return out
    from scipy import ndimage

    return ndimage.binary_closing(m).astype(np.uint8)


def find_objects(labels: np.ndarray, max_label: int):
    """Per-label bounding-box slices, matching
    scipy.ndimage.find_objects(labels, max_label): None for labels that
    never occur."""
    lab = np.ascontiguousarray(labels, np.int32)
    lib = _load()
    if lib is None:
        from scipy import ndimage

        return ndimage.find_objects(lab, max_label=max_label)
    out = np.zeros((max_label, 6), np.int64)
    lib.label_bboxes(lab, *lab.shape, max_label, out)
    return [
        None if r[0] < 0 else (
            slice(int(r[0]), int(r[1])),
            slice(int(r[2]), int(r[3])),
            slice(int(r[4]), int(r[5])),
        )
        for r in out
    ]


def box_convolve27(vol: np.ndarray) -> np.ndarray:
    """3x3x3 all-ones convolution, reflect boundary: equivalent to
    scipy.ndimage.convolve(vol, np.ones((3, 3, 3))) with mode='reflect'."""
    v = np.ascontiguousarray(vol, np.float32)
    lib = _load()
    if lib is not None:
        out = np.empty_like(v)
        lib.box_convolve27(v, *v.shape, out)
        return out
    from scipy import ndimage

    return ndimage.convolve(v, np.ones((3, 3, 3), np.float32))


def edt_with_indices(mask: np.ndarray, return_indices: bool = True):
    """Exact EDT of `mask` (distance to the nearest zero voxel), with the
    nearest zero's coordinates unless `return_indices` is False, matching
    scipy.ndimage.distance_transform_edt's contract."""
    m = np.ascontiguousarray(mask != 0).astype(np.uint8)
    lib = _load()
    if lib is not None:
        dist = np.zeros(m.shape, np.float32)
        if return_indices:
            idx = np.zeros((3,) + m.shape, np.int32)
            lib.edt_sq(m, *m.shape, dist, idx.ctypes.data_as(ctypes.c_void_p))
            return np.sqrt(dist), idx
        lib.edt_sq(m, *m.shape, dist, None)
        return np.sqrt(dist)
    from scipy import ndimage

    if return_indices:
        dist, idx = ndimage.distance_transform_edt(m, return_indices=True)
        return dist.astype(np.float32), idx.astype(np.int32)
    return ndimage.distance_transform_edt(m).astype(np.float32)
