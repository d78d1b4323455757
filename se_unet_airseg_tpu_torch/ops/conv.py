"""3-D convolution on NDHWC tensors with DHWIO kernels.

The NDHWC tensor is handed to `torch.nn.functional.conv3d` as its
NCDHW permutation, which is a `channels_last_3d` view: no copy is made
and cuDNN runs its channels-last kernels. The bias is added after the
convolution in the compute dtype, the rounding point of the JAX
package's conv (a bias fused into cuDNN would be added before the
output is rounded).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _to_oidhw(kernel: torch.Tensor) -> torch.Tensor:
    return kernel.permute(4, 3, 0, 1, 2)


def conv3d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    padding=0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Conv over NDHWC `x` with DHWIO `kernel` ((kD, kH, kW, Ci/groups,
    Co)); returns NDHWC in `x`'s dtype.

    `padding`: an int, three per-axis ints, or three (lo, hi) pairs.
    """
    if isinstance(padding, int):
        pad3 = (padding,) * 3
    else:
        padding = tuple(padding)
        if all(isinstance(p, int) for p in padding):
            pad3 = padding
        else:
            lo_hi = [tuple(p) for p in padding]
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
    ).permute(0, 2, 3, 4, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
