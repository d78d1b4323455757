"""LIB (local-intensity-bias) prior-weight map on the device.

The reference computes a local density of the airway label with a
7x7x7 ones convolution / 343, replaces zeros with 1, takes -log10, and
masks by the label (reference lib_weight.py:12-17, 36-53). Here the
box sum is one `avg_pool3d` with divisor 1 over the reflect-padded
label: the label is 0/1, so the sum is an exact integer whatever the
order of its additions, and the division by 343 is one rounding, as in
the JAX package's `reduce_window` version.

The stored artifact is float16 (`./data/LIB_weight/<case>.npy`); the
random power `w ** (U[0,1)+2)` is applied at *sample* time, not here
(reference data.py:386).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.devices import resolve_device


def lib_weight_map(label, device=None) -> torch.Tensor:
    """Per-voxel -log10(local label density) * label of a (D, H, W) mask
    (numpy array or tensor), as float32 on `device` (default `cuda`;
    raises without CUDA unless `device="cpu"`)."""
    dev = resolve_device(device)
    if isinstance(label, np.ndarray):
        label = torch.from_numpy(np.ascontiguousarray(label))
    x = label.to(dev, torch.float32)
    # scipy.ndimage.convolve(mode='mirror') == reflect-about-edge padding
    xp = F.pad(x[None, None], (3,) * 6, mode="reflect")
    dens = F.avg_pool3d(xp, 7, stride=1, divisor_override=1)[0, 0] / 343.0
    dens = torch.where(dens == 0.0, torch.ones_like(dens), dens)
    return -torch.log10(dens) * x
