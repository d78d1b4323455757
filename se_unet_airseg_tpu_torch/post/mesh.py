"""Isosurface extraction + binary STL export.

Replaces skimage marching_cubes + numpy-stl in the reference's mesh
path (reference prediction.py:126-145, ours_skel_parse.py:1023-1046):
the native library extracts a marching-tetrahedra surface; the STL
writer emits the standard 84-byte-header binary layout.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from ._native import _load


def marching_surface(volume: np.ndarray, level: float = 0.5) -> np.ndarray:
    """Triangle soup (N, 3, 3) in (z, y, x) voxel coordinates at the
    `level` isosurface (marching tetrahedra, native)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("marching_surface requires the native library")
    vol = np.ascontiguousarray(volume, np.float32)
    n = lib.march_tets(vol, *vol.shape, level, None, 0)
    if n == 0:
        return np.zeros((0, 3, 3), np.float32)
    out = np.zeros((n, 9), np.float32)
    lib.march_tets(vol, *vol.shape, level,
                   out.ctypes.data_as(ctypes.c_void_p), n)
    return out.reshape(n, 3, 3)


def write_binary_stl(path: str, triangles: np.ndarray, name: bytes = b"airseg"):
    """Binary STL: 80-byte header, uint32 count, 50 bytes/triangle
    (normal + 3 vertices + attribute). Normals are recomputed.

    Fully vectorized: one structured-array compose + one write (the
    per-triangle struct.pack loop cost ~47 s on an 886k-triangle
    CASE073 surface; this runs in well under a second)."""
    tris = np.asarray(triangles, np.float32)
    n = len(tris)
    nvec = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    norm = np.linalg.norm(nvec, axis=1, keepdims=True)
    nvec = np.divide(nvec, norm, out=nvec, where=norm > 0)
    rec = np.zeros(
        n,
        np.dtype(
            [("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")]
        ),  # packed: 12 + 36 + 2 = 50 bytes
    )
    rec["n"] = nvec
    rec["v"] = tris
    with open(path, "wb") as f:
        f.write(name.ljust(80, b"\0"))
        f.write(struct.pack("<I", n))
        f.write(rec.tobytes())


def export_mask_stl(path: str, mask: np.ndarray, *, center=None,
                    scale: float = 1.0, level: float = 0.5,
                    spacing=None):
    """Mask -> surface -> STL, with the reference's centering/scaling
    convention (vertices shifted by `center`, divided by `scale` —
    reference prediction.py:137-145 uses the skeleton centroid and 10).
    `spacing` multiplies vertices per axis to physical mm (the ATM22
    driver's convention, reference tree_parsing.py:99-103).

    Marches the foreground bounding box (margin 1) and offsets the
    vertices back — identical surface in full-volume coordinates at a
    fraction of the cell scan on 512^3 masks."""
    idx = np.argwhere(mask)
    if idx.size:
        lo = np.maximum(idx.min(axis=0) - 1, 0)
        hi = np.minimum(idx.max(axis=0) + 2, mask.shape)
        sl = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
        tris = marching_surface(mask[sl].astype(np.float32), level)
        tris = tris + lo.astype(np.float32)[None, None, :]
    else:
        tris = marching_surface(mask.astype(np.float32), level)
    if spacing is not None:
        tris = tris * np.asarray(spacing, np.float32)[None, None, :]
    if center is not None:
        tris = tris - np.asarray(center, np.float32)
    if scale != 1.0:
        tris = tris / float(scale)
    write_binary_stl(path, tris)
    return len(tris)
