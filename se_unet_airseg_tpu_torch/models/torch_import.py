"""Weight bridge between the reference state_dict naming and the
functional parameter tree.

The port's `SEUNet` module carries the reference PyTorch state_dict
names (reference SE_UNet.py:108-153), so reference `.pth` checkpoints
load straight into it. The functional forward (`apply`, `apply_fast`)
reads a parameter tree of DHWIO tensors, the JAX package's layout:

  <blk>.conv1.{weight,bias}   <-> <blk>.conv.{w,b}     (3x3x3)
  <blk>.conv2.{weight,bias}   <-> <blk>.side.{w,b}     (1x1x1 side head)
  <blk>.conv_se.weight        <-> <blk>.se0.w
  <blk>.conv_se2.weight       <-> <blk>.se1.w
  <cat>.conv1.weight          <-> <cat>.conv.w
  dc0_0.{weight,bias}         <-> head_en.{w,b}
  dc0_1.{weight,bias}         <-> head_de.{w,b}

Conv weights are (O, I, kD, kH, kW) in the state_dict, DHWIO in the
tree.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_RENAME = {"dc0_0": "head_en", "dc0_1": "head_de"}
_RENAME_INV = {v: k for k, v in _RENAME.items()}
_LEAF = {
    "conv1.weight": ("conv", "w"),
    "conv1.bias": ("conv", "b"),
    "conv2.weight": ("side", "w"),
    "conv2.bias": ("side", "b"),
    "conv_se.weight": ("se0", "w"),
    "conv_se2.weight": ("se1", "w"),
}
_LEAF_INV = {v: k for k, v in _LEAF.items()}


def _to_dhwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 4, 1, 0) if w.dim() == 5 else w


def params_from_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """Reference state_dict (tensors or arrays) -> parameter tree of
    DHWIO tensors. Tensors are taken as views, not copied."""
    params: dict = {}
    for key, val in state_dict.items():
        t = torch.as_tensor(val).detach()
        block, _, leaf = key.partition(".")
        block = _RENAME.get(block, block)
        if block in ("head_en", "head_de"):
            params.setdefault(block, {})["w" if leaf == "weight" else "b"] = _to_dhwio(t)
        elif leaf in _LEAF:
            sub, name = _LEAF[leaf]
            params.setdefault(block, {}).setdefault(sub, {})[name] = _to_dhwio(t)
        # InstanceNorm has no parameters (affine=False); pooling none
    return params


def state_dict_from_jax_params(params_np: Mapping[str, Any]) -> dict:
    """JAX parameter tree (numpy arrays, DHWIO) -> reference-named
    state_dict of float32 OIDHW tensors. Inverse of the JAX package's
    `params_from_state_dict`."""

    def oidhw(a) -> torch.Tensor:
        a = np.asarray(a, np.float32)
        if a.ndim == 5:
            a = np.transpose(a, (4, 3, 0, 1, 2))
        return torch.from_numpy(np.array(a, np.float32, order="C"))

    sd: dict = {}
    for block, sub in params_np.items():
        if block in _RENAME_INV:
            name = _RENAME_INV[block]
            sd[f"{name}.weight"] = oidhw(sub["w"])
            if "b" in sub:
                sd[f"{name}.bias"] = oidhw(sub["b"])
            continue
        for part, leaves in sub.items():
            for leaf, arr in leaves.items():
                sd[f"{block}.{_LEAF_INV[(part, leaf)]}"] = oidhw(arr)
    return sd


def load_torch_checkpoint(path: str) -> dict:
    """Load a reference `.pth` state_dict file as a parameter tree."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return params_from_state_dict(sd)
