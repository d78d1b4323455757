"""Crop augmentations with reference semantics (reference data.py:40-73).

* `random_flip` — axis flips drawn per crop but NEVER the identity
  (the (1,1,1) draw is rejected and redrawn, data.py:43-44).
* `random_rotate` — one of two 90-degree rotations in the (axis1,
  axis2) plane, p=0.5 each.
* `random_color` — brightness/contrast jitter; defined by the
  reference but unused on the main path (data.py:69-73).

All functions take an explicit numpy Generator (the reference uses the
global seeds np.random(777)/random). A copy of the JAX package's
`data/augment.py`: the same draws in the same order, so both packages
give the same crops from the same Generator.
"""

from __future__ import annotations

import numpy as np


def random_flip(arrays: list[np.ndarray], rng: np.random.Generator):
    flip = rng.integers(0, 2, 3) * 2 - 1
    while (flip == 1).all():
        flip = rng.integers(0, 2, 3) * 2 - 1
    return [np.ascontiguousarray(a[:: flip[0], :: flip[1], :: flip[2]]) for a in arrays]


def _rotate_left(a: np.ndarray) -> np.ndarray:
    a = a.transpose(0, 2, 1)
    return np.ascontiguousarray(a[:, ::-1])


def _rotate_right(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a[:, ::-1])
    a = a.transpose(0, 2, 1)
    return np.ascontiguousarray(a[:, ::-1])


def random_rotate(arrays: list[np.ndarray], rng: np.random.Generator):
    if rng.random() > 0.5:
        return [_rotate_left(a) for a in arrays]
    return [_rotate_right(a) for a in arrays]


def random_color(a: np.ndarray, rng: np.random.Generator, rate: float = 0.2):
    r1 = (rng.random() - 0.5) * 2 * rate
    r2 = (rng.random() - 0.5) * 2 * rate
    return a * (1 + r2) + r1


def augment_crops(arrays: list[np.ndarray], rng: np.random.Generator):
    """Flip with p=0.5, then rotate with p=0.5, applied jointly to all
    arrays of one crop (reference data.py:351-358)."""
    if rng.random() > 0.5:
        arrays = random_flip(arrays, rng)
    if rng.random() > 0.5:
        arrays = random_rotate(arrays, rng)
    return arrays
