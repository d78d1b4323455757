"""3-D max pooling of NDHWC tensors (MaxPool3d(2, 2) between encoder
levels)."""

import torch
import torch.nn.functional as F


def max_pool3d(x: torch.Tensor) -> torch.Tensor:
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2)
    return y.permute(0, 2, 3, 4, 1)
