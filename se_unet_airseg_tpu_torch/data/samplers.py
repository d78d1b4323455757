"""Crop samplers for the curriculum (reference data.py:85-252).

All location-guided samplers share one rule: pick a random voxel from
a coordinate set, jitter the crop start uniformly in
[max(0, loc - cube/2), loc + cube/2), clamp the crop inside the
volume. `random_crop` picks starts uniformly; `hard_sample` chooses
skeleton-miss vs small-airway sets 50/50 with fallbacks.

Every sampler takes a dict of volumes and returns a dict of crops, so
stage-specific field sets (with/without skeleton) need no _wg
duplicates like the reference's. A copy of the JAX package's
`data/samplers.py`, with the same draw order.
"""

from __future__ import annotations

import numpy as np

Arrays = dict[str, np.ndarray]


def _crop_at(arrays: Arrays, start, cube: int) -> Arrays:
    z, y, x = start
    return {
        k: v[z : z + cube, y : y + cube, x : x + cube] for k, v in arrays.items()
    }


def _jittered_start(shape, loc, cube: int, rng: np.random.Generator):
    start = []
    for i in range(3):
        lo = max(0, int(loc[i]) - cube // 2)
        hi = int(loc[i]) + cube // 2
        s = int(rng.integers(lo, max(hi, lo + 1)))
        if s + cube > shape[i]:
            s = shape[i] - cube
        start.append(max(s, 0))
    return start


def random_crop(arrays: Arrays, cube: int, rng: np.random.Generator) -> Arrays:
    shape = next(iter(arrays.values())).shape
    start = [int(rng.integers(0, shape[i] - cube)) for i in range(3)]
    return _crop_at(arrays, start, cube)


def location_crop(arrays: Arrays, loc_set, cube: int, rng: np.random.Generator) -> Arrays:
    """Crop jittered around a random coordinate from `loc_set`
    (a np.where-style tuple of index arrays)."""
    shape = next(iter(arrays.values())).shape
    k = int(rng.integers(len(loc_set[0])))
    loc = (loc_set[0][k], loc_set[1][k], loc_set[2][k])
    return _crop_at(arrays, _jittered_start(shape, loc, cube, rng), cube)


def small_airway_sampler(label, skel, rng: np.random.Generator, max_tries=64):
    """Uniform point sampler over the reference's "small airway" set
    {v : (EDT(label)·skel)(v) < 2} (data.py:305, `<2` bug-compatible:
    every non-skeleton voxel qualifies) WITHOUT materializing EDT or
    the coordinate list. The set covers ≳99.9% of the volume, so
    rejection sampling from uniform-over-volume is exact and O(1):
    accept v iff skel(v)==0, label(v)==0, or some in-bounds voxel in
    v's 26-neighborhood is background (⇔ EDT(label)(v) < 2, since the
    admissible squared offsets are 1/2/3 < 4). Replaces a full-volume
    distance_transform_edt + np.where per volume visit per epoch.

    Returns a zero-arg callable yielding a (z, y, x) point or None."""
    shape = label.shape

    def draw():
        for _ in range(max_tries):
            z = int(rng.integers(0, shape[0]))
            y = int(rng.integers(0, shape[1]))
            x = int(rng.integers(0, shape[2]))
            if skel[z, y, x] == 0 or label[z, y, x] == 0:
                return (z, y, x)
            nb = label[
                max(z - 1, 0) : z + 2,
                max(y - 1, 0) : y + 2,
                max(x - 1, 0) : x + 2,
            ]
            if not nb.all():
                return (z, y, x)
        return None

    return draw


def point_crop(arrays: Arrays, point, cube: int, rng: np.random.Generator) -> Arrays:
    shape = next(iter(arrays.values())).shape
    return _crop_at(arrays, _jittered_start(shape, point, cube, rng), cube)


def hard_sample(
    arrays: Arrays,
    loc_skeleton,
    loc_small,
    cube: int,
    rng: np.random.Generator,
) -> Arrays:
    """50/50 skeleton-miss vs small-airway, falling back to the other
    set and finally to a uniform crop (reference data.py:124-157).
    `loc_small` is a np.where-style tuple or a point-sampler callable
    from `small_airway_sampler`."""
    if rng.random() > 0.5 and len(loc_skeleton[0]) > 0:
        return location_crop(arrays, loc_skeleton, cube, rng)
    if callable(loc_small):
        p = loc_small()
        if p is not None:
            return point_crop(arrays, p, cube, rng)
    elif len(loc_small[0]) > 0:
        return location_crop(arrays, loc_small, cube, rng)
    return random_crop(arrays, cube, rng)


def centered_random_crop(arrays: Arrays, cube: int, rng) -> Arrays:
    """Stage-1 crop: center drawn uniformly in
    [cube/2, dim - cube/2] per axis (reference data.py:645-664;
    `random.randint` is INCLUSIVE on both ends there)."""
    shape = next(iter(arrays.values())).shape
    start = []
    for i in range(3):
        c = int(rng.integers(cube // 2, shape[i] - cube // 2 + 1))
        start.append(c - cube // 2)
    return _crop_at(arrays, start, cube)
