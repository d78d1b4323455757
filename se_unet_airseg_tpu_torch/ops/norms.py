"""InstanceNorm and LeakyReLU with PyTorch-default semantics
(affine=False, eps=1e-5, biased variance; slope 0.01), on NDHWC tensors.
Statistics are taken in float32 whatever the activation dtype."""

import torch

from ..parallel.mesh import space_sum


def instance_norm(x: torch.Tensor, eps: float = 1e-5, space=None) -> torch.Tensor:
    """Per-(N, C) normalization of an NDHWC tensor over D, H, W. With
    `space` (a `parallel.DataMesh` splitting the depth) x is this rank's
    depth slab: the two passes' sums add over the space ranks
    (`parallel.space_sum`) and the count is the whole crop's."""
    xf = x.to(torch.float32)
    if space is None:
        mean = xf.mean(dim=(1, 2, 3), keepdim=True)
        var = torch.square(xf - mean).mean(dim=(1, 2, 3), keepdim=True)
    else:
        n = x.shape[1] * x.shape[2] * x.shape[3] * space.space_size
        mean = space_sum(xf.sum(dim=(1, 2, 3), keepdim=True), space) / n
        var = space_sum(torch.square(xf - mean).sum(dim=(1, 2, 3), keepdim=True), space) / n
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    # the slope is rounded to x's dtype first, as the JAX package does
    slope = float(torch.tensor(negative_slope, dtype=x.dtype))
    return torch.where(x >= 0, x, x * slope)
