"""CT HU dual-windowing — the model's 2-channel input contract.

  channel 0: clip to [-1024, 1024] HU, map to [0, 1] via (x+1024)/2048
  channel 1: clip to [-1000,  500] HU, map to [0, 1] via (x+1000)/1500

Stored volumes hold `HU + 1024`; callers pass the shift themselves.
"""

import torch


def hu_dual_window(hu: torch.Tensor) -> torch.Tensor:
    """Map an HU volume (..., D, H, W) to two windowed channels (..., 2),
    float32 in [0, 1], channels on a new trailing axis (NDHWC)."""
    hu = hu.to(torch.float32)
    c0 = (torch.clamp(hu, -1024.0, 1024.0) + 1024.0) / 2048.0
    c1 = (torch.clamp(hu, -1000.0, 500.0) + 1000.0) / 1500.0
    return torch.stack([c0, c1], dim=-1)
