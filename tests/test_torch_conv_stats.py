"""The port's fused conv + statistics (ops/conv_stats.py) and its model
configuration (`SEUNetConfig(conv_stats=True)`) against the JAX package.

The wrappers and plain versions are held against the JAX Pallas kernels
`phased_conv_stats` and `dil2_conv_stats` in interpret mode, values and
gradients, at the tolerances of tests/test_pallas_s2d.py: y at 1e-5 in
float32, the sums at rtol 1e-4, atol 1e-3, gradients at 1e-4. The model
under `conv_stats` is held against JAX `apply_fast` with
use_pallas=True, use_pallas_epi=False and PALLAS_DIL2=1, and the runner
against the port's default runner. The kernels themselves run only on the
card (tests/test_torch_cuda.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_unet_airseg_tpu.models import SEUNetConfig as JaxConfig, init_params
from se_unet_airseg_tpu.models.se_unet import apply_fast as jax_apply_fast
from se_unet_airseg_tpu.ops import pallas_s2d as jps
from se_unet_airseg_tpu.ops import s2d as js2d
from se_unet_airseg_tpu_torch.infer import SlidingWindowRunner
from se_unet_airseg_tpu_torch.models import (
    SEUNet,
    SEUNetConfig,
    se_unet_apply_fast,
    state_dict_from_jax_params,
)
from se_unet_airseg_tpu_torch.ops import conv_stats as pcs
from se_unet_airseg_tpu_torch.ops import launch_counts, reset_launch_counts
from se_unet_airseg_tpu_torch.ops import s2d as ps2d

Y_TOL = dict(rtol=1e-5, atol=1e-5)
S_TOL = dict(rtol=1e-4, atol=1e-3)
G_TOL = dict(rtol=1e-4, atol=1e-4)


def _mk(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _check(got, ref):
    y, s1, s2 = (t.detach().numpy() for t in got)
    np.testing.assert_allclose(y, np.asarray(ref[0]), **Y_TOL)
    np.testing.assert_allclose(s1, np.asarray(ref[1]), **S_TOL)
    np.testing.assert_allclose(s2, np.asarray(ref[2]), **S_TOL)


def _phased_case(n, cis, co, seed):
    """Inputs of one phased call: s2d tensors of `cis` lanes forming a
    plain concat, the lifted (8, Cin, 8Co) kernel and (8Co,) bias."""
    xs = [_mk((2, n, n, n, c), seed + i) for i, c in enumerate(cis)]
    ci = sum(cis) // 8
    w = _mk((3, 3, 3, ci, co), seed + 5, 0.2)
    b = _mk((co,), seed + 6, 0.1)
    splits = tuple(c // 8 for c in cis) if len(cis) > 1 else None
    w_all, b_all = js2d.phased_conv_weights(jnp.asarray(w), jnp.asarray(b), splits)
    return xs, np.array(w_all).reshape(8, sum(cis), 8 * co), np.array(b_all)


def _loss(y, s1, s2):
    return (y * y).sum() + 0.1 * s1.sum() + 0.01 * s2.sum()


@pytest.mark.parametrize("fn", ["wrapper", "plain"])
@pytest.mark.parametrize("n,cis,co", [(8, (16,), 4), (16, (32,), 4), (8, (16, 8), 4)])
def test_phased_conv_stats_matches_jax(fn, n, cis, co):
    """(8, 2, 4), (16, 4, 4) and a two-input plain concat (Ci 2 + 1)."""
    xs, w8, b_all = _phased_case(n, cis, co, seed=n + len(cis))
    ref = jps.phased_conv_stats(jnp.concatenate([jnp.asarray(x) for x in xs], -1),
                                jnp.asarray(w8), jnp.asarray(b_all))
    f = pcs.phased_conv_stats if fn == "wrapper" else pcs.phased_conv_stats_plain
    _check(f([_t(x) for x in xs], _t(w8), _t(b_all)), ref)


@pytest.mark.parametrize("fn", ["wrapper", "plain"])
def test_dil2_conv_stats_matches_jax(fn):
    n, ci, co = 8, 2, 3
    x, w, b = _mk((2, n, n, n, 8 * ci), 11), _mk((3, 3, 3, ci, co), 12, 0.2), _mk((co,), 13, 0.1)
    ref = jps.dil2_conv_stats(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    f = pcs.dil2_conv_stats if fn == "wrapper" else pcs.dil2_conv_stats_plain
    _check(f(_t(x), _t(w), _t(b)), ref)


@pytest.mark.parametrize("cis", [(16,), (16, 8)])
def test_phased_conv_stats_grads_match_jax(cis):
    """Gradients of every input through the autograd Function against
    jax.grad through the custom vjp (test_pallas_s2d.py:73-100)."""
    xs, w8, b_all = _phased_case(8, cis, 2, seed=20 + len(cis))
    n_x = len(xs)

    def jloss(w8_, b_, *xs_):
        return _loss(*jps.phased_conv_stats(jnp.concatenate(xs_, -1), w8_, b_))

    ref = jax.grad(jloss, tuple(range(2 + n_x)))(
        jnp.asarray(w8), jnp.asarray(b_all), *(jnp.asarray(x) for x in xs))
    leaves = [_t(w8, True), _t(b_all, True)] + [_t(x, True) for x in xs]
    _loss(*pcs.phased_conv_stats(leaves[2:], leaves[0], leaves[1])).backward()
    for got, want in zip(leaves, ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **G_TOL)


def test_dil2_conv_stats_grads_match_jax():
    n, ci, co = 8, 2, 3
    x, w, b = _mk((1, n, n, n, 8 * ci), 31), _mk((3, 3, 3, ci, co), 32, 0.2), _mk((co,), 33, 0.1)
    ref = jax.grad(lambda *a: _loss(*jps.dil2_conv_stats(*a)), (0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    leaves = [_t(x, True), _t(w, True), _t(b, True)]
    _loss(*pcs.dil2_conv_stats(*leaves)).backward()
    for got, want in zip(leaves, ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **G_TOL)


def test_instance_norm_from_stats_matches_jax():
    y = _mk((2, 4, 4, 4, 32), 40, 2.0) + 0.5
    s1, s2 = y.sum((1, 2, 3)), (y.astype(np.float64) ** 2).sum((1, 2, 3)).astype(np.float32)
    ref = js2d.instance_norm_from_stats(jnp.asarray(y), jnp.asarray(s1), jnp.asarray(s2))
    got = ps2d.instance_norm_from_stats(_t(y), _t(s1), _t(s2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_polyphase_matches_jax():
    x = _mk((2, 3, 4, 5, 24), 41)
    xp = ps2d.to_polyphase(_t(x))
    np.testing.assert_array_equal(xp.numpy(), np.asarray(js2d.to_polyphase(jnp.asarray(x))))
    np.testing.assert_array_equal(ps2d.from_polyphase(xp).numpy(), x)


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the wrappers compute their plain versions and
    launch nothing."""
    xs, w8, b_all = _phased_case(4, (16, 8), 2, seed=50)
    x, w, b = _mk((1, 4, 4, 4, 16), 51), _mk((3, 3, 3, 2, 3), 52), _mk((3,), 53)
    reset_launch_counts()
    for got, want in ((pcs.phased_conv_stats([_t(a) for a in xs], _t(w8), _t(b_all)),
                       pcs.phased_conv_stats_plain([_t(a) for a in xs], _t(w8), _t(b_all))),
                      (pcs.dil2_conv_stats(_t(x), _t(w), _t(b)),
                       pcs.dil2_conv_stats_plain(_t(x), _t(w), _t(b)))):
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert {"phased_conv_stats", "dil2_conv_stats"} <= set(launch_counts)
    assert not any(launch_counts.values())


@pytest.fixture(scope="module")
def weights():
    jp = jax.jit(lambda k: init_params(k, JaxConfig()))(jax.random.key(3))
    jp = jax.tree.map(np.asarray, jp)
    model = SEUNet(SEUNetConfig())
    model.load_state_dict(state_dict_from_jax_params(jp))
    return jp, model


def test_apply_fast_conv_stats_matches_jax(weights, monkeypatch):
    """32^3, one tile, float32: the JAX forward runs K8 at the 1/2 level
    (n = 8) and K9, in interpret mode; at 16^3 the level-2 K8 calls
    (n = 4) would take JAX's XLA fallback (`_pick_tile3` needs an
    8-divisible x tile)."""
    for k in list(os.environ):  # the JAX package reads its flags at trace time
        if k.startswith(("EPI_", "PALLAS_", "FASTPATH_BM", "DIL2_MODE", "UP_SLABS")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PALLAS_DIL2", "1")
    jp, model = weights
    x = _mk((1, 32, 32, 32, 2), 60)
    cfg = JaxConfig(use_pallas=True, use_pallas_epi=False)
    ref = jax.jit(lambda p, v: jax_apply_fast(p, v, cfg=cfg))(jp, jnp.asarray(x))
    with torch.inference_mode():
        got = se_unet_apply_fast(model.params_tree(), _t(x), cfg=SEUNetConfig(conv_stats=True))
    for g, r in zip(got, ref):
        assert g.shape == (1, 32, 32, 32, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3, atol=1e-4)


def test_runner_conv_stats_matches_default(weights):
    """Whole-volume probabilities of the conv_stats runner against the
    default one, cube 32, step 16, batch 2."""
    _, model = weights
    vol = (np.random.default_rng(61).random((48, 40, 32)) * 1400 - 1000).astype(np.int16)
    kw = dict(cube=32, step=16, batch=2, device="cpu")
    ref = SlidingWindowRunner(model, SEUNetConfig(), **kw).predict_hu(vol, hu_shift=-24.0)
    got = SlidingWindowRunner(model, SEUNetConfig(conv_stats=True), **kw).predict_hu(
        vol, hu_shift=-24.0)
    assert got.shape == vol.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
