"""The port's stage-1 train step under the kernel configurations, on the CPU.

`SEUNetConfig(conv_stats=True)` and `SEUNetConfig(conv_epi=True)`, each with
remat on and off, against the default configuration: one float32 step of
`make_train_step(stage=1)` (16^3 crops, batch 2, fixed DropLayer draws,
AdamW) from the same weights. The three configurations compute the same
function through different (plain-version) conv blocks, so the loss agrees
at rtol 1e-6 and every gradient element within 1e-6 of the default's.
(Not the updated parameters: AdamW divides a gradient by its own root
mean square, so the conv biases in front of an InstanceNorm, whose
gradient is zero up to rounding, take steps of the learning rate's size
in either direction.) Port only: no JAX."""

import numpy as np
import pytest
import torch

from se_unet_airseg_tpu_torch.models import SEUNet, SEUNetConfig
from se_unet_airseg_tpu_torch.models.se_unet import _leaves
from se_unet_airseg_tpu_torch.train import create_train_state, make_optimizer, make_train_step

B, S = 2, 16


@pytest.fixture(scope="module")
def setup():
    tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(0)).params_tree()
    r = np.random.default_rng(1)
    batch = {"image": torch.from_numpy(r.random((B, S, S, S, 2)).astype(np.float32)),
             "label": torch.from_numpy((r.random((B, S, S, S)) > 0.7).astype(np.float32))}
    draws = [torch.from_numpy(r.random((B, c)).astype(np.float32)) for c in (24, 12)]
    return tree, batch, draws


def _step(setup, cfg):
    """(loss, gradients) of one stage-1 step."""
    tree, batch, draws = setup
    state = create_train_state(tree, make_optimizer()[0])
    state, aux = make_train_step(cfg, stage=1)(state, batch, drop_draws=draws)
    grads = [torch.zeros(t.shape) if t.grad is None else t.grad for t in _leaves(state.params)]
    return float(aux["loss"]), grads


@pytest.fixture(scope="module")
def default_step(setup):
    return _step(setup, SEUNetConfig())


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("kind", ["conv_stats", "conv_epi"])
def test_train_step_matches_default(setup, default_step, kind, remat):
    loss, grads = _step(setup, SEUNetConfig(remat=remat, **{kind: True}))
    ref_loss, ref_grads = default_step
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
    assert len(grads) == len(ref_grads)
    assert any(float(g.abs().max()) > 0 for g in ref_grads)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)
