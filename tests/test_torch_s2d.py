"""The port's space-to-depth algebra (se_unet_airseg_tpu_torch.ops.s2d)
against the JAX package's ops/s2d.py on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_unet_airseg_tpu.ops import s2d as js
from se_unet_airseg_tpu_torch.ops import s2d as ps

ATOL, RTOL = 2e-6, 1e-5


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def test_space_to_depth_roundtrip():
    x = _rand(0, (2, 4, 6, 8, 3))
    s = ps.space_to_depth(_t(x))
    _close(s, js.space_to_depth(jnp.asarray(x)), atol=0, rtol=0)
    _close(ps.depth_to_space(s), x, atol=0, rtol=0)


def test_block_lift_and_bias():
    w = _rand(1, (3, 3, 3, 2, 4))
    np.testing.assert_array_equal(ps._block_lift_tensor(), js._block_lift_tensor())
    _close(ps.conv3_weight_to_s2d(_t(w)), js.conv3_weight_to_s2d(jnp.asarray(w)))
    b = _rand(2, (4,))
    _close(ps.bias_to_s2d(_t(b)), js.bias_to_s2d(jnp.asarray(b)), atol=0, rtol=0)


def test_lifted_conv_equals_full_resolution_conv():
    """conv3d(s2d(x), lift(w)) == s2d(conv3d(x, w)) — the ec1/ec2 rewrite."""
    from se_unet_airseg_tpu_torch.ops import conv3d

    x, w, b = _rand(3, (1, 8, 8, 8, 2)), _rand(4, (3, 3, 3, 2, 4), 0.3), _rand(5, (4,))
    full = ps.space_to_depth(conv3d(_t(x), _t(w), _t(b), padding=1))
    lifted = conv3d(ps.space_to_depth(_t(x)), ps.conv3_weight_to_s2d(_t(w)),
                    ps.bias_to_s2d(_t(b)), padding=1)
    torch.testing.assert_close(lifted, full, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bias", [False, True])
def test_grouped_pointwise(bias):
    x, w = _rand(6, (2, 3, 3, 3, 24)), _rand(7, (3, 5))
    b = _rand(8, (5,)) if bias else None
    ref = js.grouped_pointwise(jnp.asarray(x), jnp.asarray(w),
                               None if b is None else jnp.asarray(b))
    _close(ps.grouped_pointwise(_t(x), _t(w), None if b is None else _t(b)), ref)


@pytest.mark.parametrize("counts", [(2,), (4, 1, 2), (3, 5)])
def test_grouped_pointwise_multi(counts):
    w = _rand(9, (sum(counts), 6))
    xs = [_rand(10 + i, (2, 3, 3, 3, 8 * c)) for i, c in enumerate(counts)]
    wd_j = js.grouped_pointwise_multi_weight(jnp.asarray(w), counts, jnp.float32)
    wd_p = ps.grouped_pointwise_multi_weight(_t(w), counts, torch.float32)
    _close(wd_p, wd_j, atol=0, rtol=0)
    ref = js.grouped_pointwise_multi_pre([jnp.asarray(x) for x in xs], wd_j)
    _close(ps.grouped_pointwise_multi_pre([_t(x) for x in xs], wd_p), ref)
    assert ps.plain_to_interleaved_perm(counts) == js.plain_to_interleaved_perm(counts)


def test_instance_norm_s2d():
    x = _rand(11, (2, 4, 4, 4, 48), 2.0) + 0.5
    _close(ps.instance_norm_s2d(_t(x)), js.instance_norm_s2d(jnp.asarray(x)))


@pytest.mark.parametrize("ng", [1, 2, 4])
def test_dil2_weights(ng):
    w = _rand(12, (3, 3, 3, 4, 3))
    _close(ps.dil2_group_weight(_t(w), ng, torch.float32),
           js.dil2_group_weight(jnp.asarray(w), ng, jnp.float32), atol=0, rtol=0)


def test_dil2_grouped_conv_equals_full_resolution_dil2_conv():
    """The grouped partial-dense conv on s2d == s2d of the dilation-2 conv."""
    from se_unet_airseg_tpu_torch.ops import conv3d

    x, w, b = _rand(13, (1, 8, 8, 8, 4)), _rand(14, (3, 3, 3, 4, 3), 0.3), _rand(15, (3,))
    full = ps.space_to_depth(conv3d(_t(x), _t(w), _t(b), padding=2, dilation=2))
    s2d = conv3d(ps.space_to_depth(_t(x)), ps.dil2_group_weight(_t(w), 2, torch.float32),
                 _t(b).repeat(8), padding=1, groups=2)
    torch.testing.assert_close(s2d, full, atol=1e-5, rtol=1e-5)


def test_se_gate():
    x, w_se = _rand(16, (2, 3, 3, 3, 40)), _rand(17, (5, 1))
    wg_j, oh_j = js.se_gate_weights(jnp.asarray(w_se), jnp.float32)
    wg_p, oh_p = ps.se_gate_weights(_t(w_se), torch.float32)
    _close(wg_p, wg_j, atol=0, rtol=0)
    _close(oh_p, oh_j, atol=0, rtol=0)
    _close(ps.se_gate_s2d_pre(_t(x), wg_p, oh_p), js.se_gate_s2d_pre(jnp.asarray(x), wg_j, oh_j))


def test_max_pool_s2d():
    x = _rand(18, (2, 3, 3, 3, 32))
    _close(ps.max_pool_s2d(_t(x)), js.max_pool_s2d(jnp.asarray(x)), atol=0, rtol=0)


@pytest.mark.parametrize("m,scale,use_pair", [(4, 2, False), (4, 2, True), (2, 4, True),
                                              (2, 8, False)])
def test_upsample_to_s2d(m, scale, use_pair):
    x = _rand(19, (2, m, m, m, 8))
    pair_np = js._interp_pair(m, m * scale)
    np.testing.assert_array_equal(ps._interp_pair(m, m * scale), pair_np)
    ref = js.upsample_to_s2d(jnp.asarray(x), scale,
                             pair=jnp.asarray(pair_np) if use_pair else None)
    got = ps.upsample_to_s2d(_t(x), scale, pair=_t(pair_np) if use_pair else None)
    _close(got, ref)


@pytest.mark.parametrize("splits", [None, (2, 3)])
def test_phased_conv_weights(splits):
    ci = sum(splits) if splits else 4
    w, b = _rand(20, (3, 3, 3, ci, 3)), _rand(21, (3,))
    for a, bb, c in [(0, 0, 0), (1, 0, 1), (1, 1, 1)]:
        np.testing.assert_array_equal(ps._phase_lift_tensor(a, bb, c),
                                      js._phase_lift_tensor(a, bb, c))
    wj, bj = js.phased_conv_weights(jnp.asarray(w), jnp.asarray(b), splits)
    wp, bp = ps.phased_conv_weights(_t(w), _t(b), splits)
    _close(wp, wj)
    _close(bp, bj, atol=0, rtol=0)
