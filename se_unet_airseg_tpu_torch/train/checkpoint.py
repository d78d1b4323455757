"""Per-epoch weight snapshots of the port's parameter tree.

The reference saves a bare state_dict every epoch per stage
(`saved_model/stage_*/SE_UNet_<ep>.pth`, reference train.py:322-324,
510-512, 625-627). The port keeps the cadence and naming
(`SE_UNet_<ep>.pt`) and stores its parameter tree (DHWIO tensors,
`torch.save`), which `SlidingWindowRunner` takes as it is; reference
`.pth` state_dicts load through `models.load_torch_checkpoint`.
"""

from __future__ import annotations

import os

import torch

from ..models.torch_import import load_torch_checkpoint


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().to("cpu").contiguous()


def save_params(params, model_dir: str, epoch: int) -> str:
    """Write the parameter tree to `<model_dir>/SE_UNet_<epoch>.pt`;
    returns the path."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"SE_UNet_{epoch}.pt")
    torch.save(_to_host(params), path)
    return path


def load_params(path: str) -> dict:
    """Load a parameter tree (on the CPU) from a `.pt` file written by
    `save_params` or a reference `.pth` state_dict."""
    if path.endswith(".pth"):
        return load_torch_checkpoint(path)
    return torch.load(path, map_location="cpu", weights_only=True)
