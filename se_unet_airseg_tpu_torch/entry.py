"""Compile-check entry point of the port: the counterpart of the JAX
repository's `__graft_entry__.entry()`.

    import torch
    from se_unet_airseg_tpu_torch.entry import entry
    fn, args = entry()
    print(fn(*args).shape)   # torch.Size([1, 128, 128, 128])
"""

from __future__ import annotations

import torch

from .models.se_unet import SEUNet, SEUNetConfig, apply_fast
from .utils.devices import resolve_device


def entry(device=None):
    """(fn, args): the bf16 eval forward of the s2d fast path on one
    128^3 tile, batch 1, on `device` (default `cuda`; raises without
    CUDA unless `device="cpu"`), with weights drawn from seed 0.
    `fn(params, x)` returns the decoder head's sigmoid, (1, 128, 128, 128)
    float32."""
    dev = resolve_device(device)
    cfg = SEUNetConfig(compute_dtype=torch.bfloat16)
    model = SEUNet(cfg, generator=torch.Generator().manual_seed(0))
    params = model.to(dev).params_tree()

    @torch.inference_mode()
    def fwd(params, x):
        _, de = apply_fast(params, x, cfg=cfg)
        return torch.sigmoid(de[..., 0].to(torch.float32))

    x = torch.zeros((1, 128, 128, 128, 2), dtype=torch.float32, device=dev)
    return fwd, (params, x)
