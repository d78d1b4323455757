"""The port's curriculum losses (se_unet_airseg_tpu_torch.losses) against
the JAX package's (se_unet_airseg_tpu/losses.py) on the same numpy
inputs, float32, rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_unet_airseg_tpu import losses as jl
from se_unet_airseg_tpu_torch import losses as pl


def _inputs():
    r = np.random.default_rng(0)
    shape = (2, 8, 8, 8)
    prob = r.random(shape).astype(np.float32)
    target = (r.random(shape) > 0.7).astype(np.float32)
    weight = (0.5 + r.random(shape)).astype(np.float32)
    skel = (target * (r.random(shape) > 0.5)).astype(np.float32)
    return {"prob": prob, "prob_en": prob[::-1].copy(), "target": target,
            "weight": weight, "skel": skel}


CASES = {
    "dice_loss": ("prob", "target"),
    "general_union_loss": ("prob", "target", "weight"),
    "atr_loss": ("prob", "skel", "weight"),
    "tversky_loss": ("prob", "target"),
    "root_tversky_loss": ("prob", "target"),
    "stage1_loss": ("prob_en", "prob", "target"),
    "stage2_loss": ("prob_en", "prob", "target", "weight"),
    "stage3_loss": ("prob_en", "prob", "target", "weight", "skel"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_jax(name):
    data = _inputs()
    args = [data[k] for k in CASES[name]]
    ref = float(getattr(jl, name)(*(jnp.asarray(a) for a in args)))
    got = getattr(pl, name)(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)


def test_losses_sum_bf16_in_float32():
    """bf16 probabilities are summed in float32, as the JAX losses do."""
    data = _inputs()
    p16 = torch.from_numpy(data["prob"]).to(torch.bfloat16)
    ref = float(jl.dice_loss(jnp.asarray(p16.float().numpy()), jnp.asarray(data["target"])))
    got = pl.dice_loss(p16, torch.from_numpy(data["target"]))
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)
