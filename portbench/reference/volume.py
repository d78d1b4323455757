"""Plain whole-volume prediction: the tiles, their overlap average and the
trit coding, worked out again from the stored volume.

Tiling as the published test loop tiles (reference data.py:731-773): cubes
at a fixed stride, the last window of each axis clamped inward to end at
the volume's edge, a volume smaller than a cube padded up to it with air,
and the position list padded to a whole number of batches by repeating the
first position, whose duplicates count twice in both the sum and the
overlap count. Each tile's decoder head goes through a sigmoid and is
summed; the average is the sum times the reciprocal of the count; the trit
is 0 below `l`, 1 from `l`, 2 from `h`.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .seunet import dual_window, forward


def axis_starts(extent: int, cube: int, step: int) -> list[int]:
    rem = (extent - cube) % step
    n = (extent - cube) // step + (1 if rem == 0 else 2)
    return [min(step * i, extent - cube) for i in range(n)]


def positions(shape, cube: int, step: int, batch: int) -> list[tuple[int, int, int]]:
    xs, ys, zs = (axis_starts(int(e), cube, step) for e in shape)
    pos = [(x, y, z) for x in xs for y in ys for z in zs]
    return pos + [pos[0]] * ((-len(pos)) % batch)


def predict_trits(sd: dict, stored: np.ndarray, *, cube: int, step: int, batch: int,
                  h: float, l: float, hu_shift: float, device,
                  quant: str | None = None) -> np.ndarray:
    """uint8 trits of an int16 stored volume (HU - hu_shift), one tile at a
    time through the plain forward."""
    shape = np.maximum(np.asarray(stored.shape), cube)
    pads = [(0, int(t - s)) for s, t in zip(stored.shape, shape)]
    vol = np.pad(stored.astype(np.float32), pads, constant_values=-1024.0 - hu_shift)
    hu = torch.from_numpy(vol).to(device) + hu_shift
    acc = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    cnt = torch.zeros_like(acc)
    with torch.no_grad():
        for (x, y, z), times in Counter(positions(shape, cube, step, batch)).items():
            win = (slice(x, x + cube), slice(y, y + cube), slice(z, z + cube))
            _, de = forward(sd, dual_window(hu[win])[None], quant=quant)
            acc[win] += times * torch.sigmoid(de[0, 0])
            cnt[win] += times
    avg = acc * (1.0 / torch.clamp(cnt, min=1.0))
    d, hh, w = stored.shape
    avg = avg[:d, :hh, :w]
    trits = (avg >= l).to(torch.uint8) + (avg >= h).to(torch.uint8)
    return trits.cpu().numpy()
