"""Device resolution for the port's entry points.

The port's hot path is CUDA: an entry point that was given no device
runs on the GPU, and raises when there is none rather than carrying on
quietly on the CPU. Tests and CPU debugging pass `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> `cuda` (raises without CUDA); anything else is taken as
    given (`"cpu"`, `"cuda:1"`, a `torch.device`)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
