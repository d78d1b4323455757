"""Sliding-window tile positions: fixed cubes at a fixed stride, the
last window of each axis clamped inward so it ends at the volume edge,
and the position list padded to a multiple of the batch by repeating
the first position (duplicates cancel in the overlap-count average).
Semantics of reference data.py:731-773."""

from __future__ import annotations

import numpy as np


def _axis_starts(extent: int, cube: int, step: int) -> list[int]:
    if extent < cube:
        raise ValueError(f"volume extent {extent} smaller than cube {cube}")
    rem = (extent - cube) % step
    n = (extent - cube) // step + (1 if rem == 0 else 2)
    return [min(step * i, extent - cube) for i in range(n)]


def tile_positions(shape, cube: int = 128, step: int = 64) -> np.ndarray:
    """All (x, y, z) tile starts for a (D, H, W) volume, raster order."""
    xs = _axis_starts(shape[0], cube, step)
    ys = _axis_starts(shape[1], cube, step)
    zs = _axis_starts(shape[2], cube, step)
    return np.asarray([(x, y, z) for x in xs for y in ys for z in zs], dtype=np.int32)


def pad_positions_to_batch(pos: np.ndarray, batch: int) -> np.ndarray:
    """Pad to a multiple of `batch` by repeating the first position."""
    if len(pos) % batch == 0:
        return pos
    n_pad = batch - (len(pos) % batch)
    return np.concatenate([pos, np.repeat(pos[:1], n_pad, axis=0)], axis=0)
