"""3-D convolution on NDHWC tensors with DHWIO kernels.

The NDHWC tensor is handed to `torch.nn.functional.conv3d` (or
`conv_transpose3d`) as its NCDHW permutation, which is a
`channels_last_3d` view: no copy is made and cuDNN runs its channels-last
kernels. The bias is added after the
convolution in the compute dtype, the rounding point of the JAX
package's conv (a bias fused into cuDNN would be added before the
output is rounded).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.mesh import halo


def _to_oidhw(kernel: torch.Tensor) -> torch.Tensor:
    return kernel.permute(4, 3, 0, 1, 2)


def _pairs(padding) -> list:
    """`padding` as three (lo, hi) pairs."""
    if isinstance(padding, int):
        return [(padding, padding)] * 3
    padding = tuple(padding)
    if all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    return [tuple(p) for p in padding]


def conv3d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    padding=0,
    dilation: int = 1,
    groups: int = 1,
    stride: int = 1,
    space=None,
) -> torch.Tensor:
    """Conv over NDHWC `x` with DHWIO `kernel` ((kD, kH, kW, Ci/groups,
    Co)); returns NDHWC in `x`'s dtype.

    `padding`: an int, three per-axis ints, or three (lo, hi) pairs.
    `stride`: the same on every axis (not with `space`).
    `space`: a `parallel.DataMesh` whose `space` axis splits the depth; x
    is then this rank's depth slab, and the depth padding comes from the
    neighbouring slabs (`parallel.halo`, zero planes at the crop's ends):
    the output is this rank's slab of the conv of the whole crop.
    """
    lo_hi = _pairs(padding)
    if space is not None and stride != 1:
        raise ValueError("a strided conv does not take a depth slab")
    if space is not None:
        x = halo(x, *lo_hi[0], space)
        lo_hi[0] = (0, 0)
    if all(lo == hi for lo, hi in lo_hi):
        pad3 = tuple(lo for lo, _ in lo_hi)
    else:
        # asymmetric: pad explicitly (F.pad takes the last axis first)
        flat = []
        for lo, hi in reversed(lo_hi):
            flat += [lo, hi]
        x = F.pad(x, [0, 0] + flat)
        pad3 = (0, 0, 0)
    y = F.conv3d(
        x.permute(0, 4, 1, 2, 3),
        _to_oidhw(kernel).to(x.dtype),
        padding=pad3,
        dilation=dilation,
        groups=groups,
        stride=stride,
    ).permute(0, 2, 3, 4, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def conv_transpose3d(x: torch.Tensor, kernel: torch.Tensor, *, stride: int) -> torch.Tensor:
    """Transposed conv over NDHWC `x` with a (kD, kH, kW, Ci, Co) `kernel`
    and no padding: (B, D, H, W, Ci) -> (B, (D-1)s + kD, ..., Co) in `x`'s
    dtype, on cuDNN's channels-last kernels as `conv3d`."""
    return F.conv_transpose3d(
        x.permute(0, 4, 1, 2, 3),
        kernel.permute(3, 4, 0, 1, 2).to(x.dtype),
        stride=stride,
    ).permute(0, 2, 3, 4, 1)
