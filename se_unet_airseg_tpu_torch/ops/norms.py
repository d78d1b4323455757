"""InstanceNorm and LeakyReLU with PyTorch-default semantics
(affine=False, eps=1e-5, biased variance; slope 0.01), on NDHWC tensors.
Statistics are taken in float32 whatever the activation dtype."""

import torch


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(N, C) normalization of an NDHWC tensor over D, H, W."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = torch.square(xf - mean).mean(dim=(1, 2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    # the slope is rounded to x's dtype first, as the JAX package does
    slope = float(torch.tensor(negative_slope, dtype=x.dtype))
    return torch.where(x >= 0, x, x * slope)
