"""The port's SE-UNet (se_unet_airseg_tpu_torch.models) against the JAX
package's: one weight set through the weight bridge, the same numpy
input, float32 on CPU.

`apply_fast` is held against JAX `apply_fast` with the Pallas epilogue
on (interpret mode): B=2 reaches the batch-major kernels (K3/K4), B=8 the
batch-minor ones (K1/K2). Both are also held against JAX `apply`.
Tolerance atol=2e-5, rtol=1e-4."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_unet_airseg_tpu.models import SEUNetConfig as JaxConfig, init_params
from se_unet_airseg_tpu.models.se_unet import apply as jax_apply
from se_unet_airseg_tpu.models.se_unet import apply_fast as jax_apply_fast
from se_unet_airseg_tpu.models.torch_import import params_from_state_dict as jax_from_sd
from se_unet_airseg_tpu_torch.models import (
    SEUNet,
    SEUNetConfig,
    get_model,
    prepare_fast_params,
    se_unet_apply,
    se_unet_apply_fast,
    state_dict_from_jax_params,
)

ATOL, RTOL = 2e-5, 1e-4
_JAX_FLAG_PREFIXES = ("EPI_", "PALLAS_", "FASTPATH_BM", "DIL2_MODE", "UP_SLABS")


@pytest.fixture(scope="module")
def weights():
    """JAX parameters as numpy, and the port's parameter tree built from
    them through the bridge."""
    jp = jax.jit(lambda k: init_params(k, JaxConfig()))(jax.random.key(0))
    jp = jax.tree.map(np.asarray, jp)
    model = SEUNet(SEUNetConfig())
    model.load_state_dict(state_dict_from_jax_params(jp))
    return jp, model.params_tree()


@pytest.fixture
def clean_jax_flags(monkeypatch):
    # the JAX package reads its tuning flags at trace time
    for k in list(os.environ):
        if k.startswith(_JAX_FLAG_PREFIXES):
            monkeypatch.delenv(k)


def _x(b, s=32, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, s, s, 2)).astype(np.float32)


def _check(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b", [2, 8])
def test_apply_fast_matches_jax(b, weights, clean_jax_flags):
    jp, tree = weights
    x = _x(b)
    jfast = jax.jit(lambda p, v: jax_apply_fast(p, v, cfg=JaxConfig(use_pallas_epi=True)))
    ref_fast = jfast(jp, jnp.asarray(x))
    ref_plain = jax.jit(lambda p, v: jax_apply(p, v, cfg=JaxConfig()))(jp, jnp.asarray(x))
    with torch.inference_mode():
        got = se_unet_apply_fast(tree, torch.from_numpy(x), cfg=SEUNetConfig())
    assert got[0].shape == (b, 32, 32, 32, 1)
    _check(got, ref_fast)
    _check(got, ref_plain)


def test_apply_matches_jax(weights):
    jp, tree = weights
    x = _x(1, 16, seed=2)
    ref = jax.jit(lambda p, v: jax_apply(p, v, cfg=JaxConfig()))(jp, jnp.asarray(x))
    with torch.inference_mode():
        _check(se_unet_apply(tree, torch.from_numpy(x), cfg=SEUNetConfig()), ref)


def test_s2d_io_and_prepared_params_change_no_values(weights):
    """x_is_s2d / heads_s2d and precomputed fast params are layout and
    caching knobs only."""
    from se_unet_airseg_tpu_torch.ops.s2d import depth_to_space, space_to_depth

    _, tree = weights
    cfg = SEUNetConfig()
    x = torch.from_numpy(_x(1, 16, seed=3))
    with torch.inference_mode():
        ref = se_unet_apply_fast(tree, x, cfg=cfg)
        fp = prepare_fast_params(tree, cfg, n=8)
        got = se_unet_apply_fast(tree, space_to_depth(x), cfg=cfg, fast_params=fp,
                                 x_is_s2d=True, heads_s2d=True)
    for g, r in zip(got, ref):
        assert g.shape == (1, 8, 8, 8, 8)
        torch.testing.assert_close(depth_to_space(g), r, atol=1e-6, rtol=1e-5)


def test_module_forward_is_apply_fast(weights):
    _, tree = weights
    model = SEUNet(SEUNetConfig())
    x = torch.from_numpy(_x(1, 16, seed=4))
    with torch.inference_mode():
        got = model(x)
        ref = se_unet_apply_fast(model.params_tree(), x, cfg=SEUNetConfig())
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=0, rtol=0)


def test_load_torch_checkpoint(weights, tmp_path):
    """A reference-named `.pth` state_dict loads as the parameter tree
    that the bridge gives."""
    from se_unet_airseg_tpu_torch.models import load_torch_checkpoint

    jp, tree = weights
    path = tmp_path / "ref.pth"
    torch.save(state_dict_from_jax_params(jp), path)
    got = load_torch_checkpoint(str(path))
    assert got.keys() == tree.keys()
    for name, sub in tree.items():
        for part, leaf in sub.items():
            if isinstance(leaf, dict):
                for k, t in leaf.items():
                    torch.testing.assert_close(got[name][part][k], t, atol=0, rtol=0)
            else:
                torch.testing.assert_close(got[name][part], leaf, atol=0, rtol=0)


def test_bridge_round_trips_through_jax_params_from_state_dict(weights):
    jp, _ = weights
    back = jax_from_sd(state_dict_from_jax_params(jp))
    flat_a, tree_a = jax.tree.flatten(jp)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_module_carries_reference_state_dict_names(weights):
    sd = SEUNet(SEUNetConfig()).state_dict()
    for key in ("ec1.conv1.weight", "ec1.conv1.bias", "ec1.conv2.weight",
                "ec1.conv_se.weight", "ec4.conv_se2.weight", "ec33.conv1.weight",
                "dc0_0.weight", "dc0_1.bias"):
        assert key in sd
    assert "ec1.conv_se2.weight" not in sd and "ec33.conv1.bias" not in sd
    assert sd["ec1.conv1.weight"].shape == (8, 2, 3, 3, 3)
    assert set(sd) == set(state_dict_from_jax_params(weights[0]))


def test_init_is_seeded_by_generator():
    a = SEUNet(generator=torch.Generator().manual_seed(3)).state_dict()
    b = SEUNet(generator=torch.Generator().manual_seed(3)).state_dict()
    c = SEUNet(generator=torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["ec1.conv1.weight"], c["ec1.conv1.weight"])
    bound = 1 / np.sqrt(2 * 27)
    assert float(a["ec1.conv1.weight"].abs().max()) <= bound


def test_train_mode_raises(weights):
    _, tree = weights
    x = torch.zeros(1, 16, 16, 16, 2)
    for fn in (se_unet_apply, se_unet_apply_fast):
        with pytest.raises(NotImplementedError, match="train slice"):
            fn(tree, x, cfg=SEUNetConfig(), train=True)


def test_get_model_device_rule():
    cfg, model = get_model(seed=0, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_model(seed=0)
