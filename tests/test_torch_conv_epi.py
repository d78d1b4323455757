"""The port's conv-to-epilogue configuration (`SEUNetConfig(conv_epi=True)`)
against the JAX package.

The plain versions of the dense dil-2 conv + statistics kernel and of the
ungathered phased conv kernel (ops/conv_stats.py) are held against the JAX
Pallas kernels `dil2_conv_stats_bm`, `phased_conv_ext_bm` and
`_pconv_kgrid_forward` in interpret mode, on the transposed (batch-minor)
inputs they take; the two blocks (ops/epilogue_s2d.py), values and
gradients, against `dil2_gated_block_bm` and `phased_gated_block_bm`
under `jax.grad`; the model against JAX `apply_fast` with
batch_minor=True, use_pallas_epi=True and PALLAS_DIL2BM=1 (16^3, batch
2), and against the port's default configuration; the runner against the
default runner. Float32 throughout, at the tolerances of
tests/test_pallas_epi.py: atol 2e-5, rtol 1e-4; the model at rtol 1e-3,
atol 1e-4. The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

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
from se_unet_airseg_tpu_torch.ops import epilogue_s2d as eps
from se_unet_airseg_tpu_torch.ops import launch_counts, reset_launch_counts
from se_unet_airseg_tpu_torch.ops import s2d as ps2d

TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _jax_flags(monkeypatch):
    """The JAX package reads its flags at trace time: clear them, then
    route its dil-2 blocks to the Pallas kernel."""
    for k in list(os.environ):
        if k.startswith(("EPI_", "PALLAS_", "FASTPATH_BM", "DIL2_MODE", "UP_SLABS")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PALLAS_DIL2BM", "1")


def _mk(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _bm(a):
    """(B, n, n, n, C) -> the batch-minor (n, n, n, B, C) the JAX kernels take."""
    return jnp.asarray(np.ascontiguousarray(np.moveaxis(a, 0, 3)))


def _from_bm(a):
    return np.moveaxis(np.asarray(a), 3, 0)


def _gates(co, gates, seed):
    """Compact (G, C) gate vectors and the JAX padded (wgs, oh)."""
    wse = _mk((gates, co), seed, 0.1)
    wgs, oh = [], None
    for g in range(gates):
        wg, oh_ = js2d.se_gate_weights(jnp.asarray(wse[g][:, None]), jnp.float32)
        wgs.append(jnp.pad(wg, ((0, 0), (0, 128 - wg.shape[1]))))
        oh = jnp.pad(oh_, ((0, 128 - oh_.shape[0]), (0, 0)))
    return wse, jnp.stack(wgs), oh


def _wse_grad(dwgs, co):
    """The compact (G, C) gradient from the JAX padded gate weights':
    wgs[g, p*C + c, p] = wse[g, c]."""
    d = np.asarray(dwgs)
    return np.stack([sum(d[g, p * co:(p + 1) * co, p] for p in range(8))
                     for g in range(d.shape[0])])


def test_dil2_dense_conv_stats_matches_jax():
    """A random DENSE kernel (not the block-diagonal lift), C8 = C8o = 128,
    n = 4, B = 2: y, s1, s2 of the wrapper and the plain version."""
    x, wd, bg = _mk((2, 4, 4, 4, 128), 1), _mk((3, 3, 3, 128, 128), 2, 0.03), _mk((128,), 3, 0.1)
    ref = jps.dil2_conv_stats_bm(_bm(x), jnp.asarray(wd), jnp.asarray(bg))
    assert ref is not None  # the Pallas kernel ran, not a fallback
    for f in (pcs.dil2_dense_conv_stats, pcs.dil2_dense_conv_stats_plain):
        y, s1, s2 = (t.numpy() for t in f(_t(x), _t(wd), _t(bg)))
        np.testing.assert_allclose(y, _from_bm(ref[0]), **TOL)
        np.testing.assert_allclose(s1, np.asarray(ref[1]), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(s2, np.asarray(ref[2]), rtol=1e-4, atol=1e-3)


def test_dil2_dense_on_block_diagonal_weight_matches_dil2_conv_stats():
    """On `dil2_dense_weight(w)` the dense form computes K9's function."""
    x, w, b = _mk((2, 6, 6, 6, 32), 4), _mk((3, 3, 3, 4, 8), 5, 0.2), _mk((8,), 6, 0.1)
    got = pcs.dil2_dense_conv_stats_plain(
        _t(x), ps2d.dil2_dense_weight(_t(w), torch.float32), _t(b).repeat(8))
    ref = pcs.dil2_conv_stats_plain(_t(x), _t(w), _t(b))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


def _phased_case(cis, co, seed, b=2, n=4):
    """Inputs of one phased call: s2d tensors of `cis` lanes forming a
    plain concat, the lifted (2, 2, 2, Cin, 8Co) kernel and (8Co,) bias."""
    xs = [_mk((b, n, n, n, c), seed + i) for i, c in enumerate(cis)]
    w = _mk((3, 3, 3, sum(cis) // 8, co), seed + 5, 0.1)
    bias = _mk((co,), seed + 6, 0.1)
    splits = tuple(c // 8 for c in cis) if len(cis) > 1 else None
    w_all, b_all = js2d.phased_conv_weights(jnp.asarray(w), jnp.asarray(bias), splits)
    return xs, np.array(w_all), np.array(b_all)


@pytest.mark.parametrize("cis,co,bias", [((128,), 16, True), ((128, 128), 32, True),
                                         ((128,), 16, False)])
def test_phased_conv_ungathered_matches_jax(cis, co, bias):
    """phased_conv_ext_bm, one and two inputs, with and without bias."""
    xs, w_all, b_all = _phased_case(cis, co, seed=10 + len(cis) + co)
    b_all = b_all if bias else None
    ref = jps.phased_conv_ext_bm([_bm(x) for x in xs], jnp.asarray(w_all),
                                 None if b_all is None else jnp.asarray(b_all))
    assert ref is not None
    for f in (pcs.phased_conv_ungathered, pcs.phased_conv_ungathered_plain):
        got = f([_t(x) for x in xs], _t(w_all), None if b_all is None else _t(b_all))
        assert got.shape == (2, 5, 5, 5, 8 * co)
        np.testing.assert_allclose(got.numpy(), _from_bm(ref), **TOL)


def test_phased_conv_ungathered_matches_jax_kgrid():
    """The k-grid form of the TPU kernel computes the same function."""
    cis, co = (128, 128), 16
    xs, w_all, b_all = _phased_case(cis, co, seed=30)
    n, b = 4, 2
    kg = jps._pconv_bm_pick_kgrid(n + 1, n + 2, b, list(cis), 8 * co, 4)
    assert kg is not None
    ref = jps._pconv_kgrid_forward([_bm(x) for x in xs], jnp.asarray(w_all),
                                   jnp.asarray(b_all), kg[1])
    got = pcs.phased_conv_ungathered_plain([_t(x) for x in xs], _t(w_all), _t(b_all))
    np.testing.assert_allclose(got.numpy(), _from_bm(ref), **TOL)


@pytest.mark.parametrize("gates", [1, 2])
def test_dil2_gated_block_matches_jax(gates):
    """Forward and the gradients of x, wd, bg and the gate vectors against
    jax.grad through dil2_gated_block_bm's custom vjp."""
    ci, co, n = 16, 16, 4
    x = _mk((2, n, n, n, 8 * ci), 40 + gates) * 2 + 0.5
    w, b = _mk((3, 3, 3, ci, co), 42, 0.1), _mk((co,), 43, 0.1)
    wd = np.array(js2d.dil2_dense_weight(jnp.asarray(w), jnp.float32))
    bg = np.tile(b, 8)
    wse, wgs, oh = _gates(co, gates, 44)
    ct = _mk((2, n, n, n, 8 * co), 45)

    def jloss(x_, wd_, bg_, wgs_):
        return jnp.sum(jps.dil2_gated_block_bm(x_, wd_, bg_, wgs_, oh) * _bm(ct))

    ref = jps.dil2_gated_block_bm(_bm(x), jnp.asarray(wd), jnp.asarray(bg), wgs, oh)
    jg = jax.grad(jloss, (0, 1, 2, 3))(_bm(x), jnp.asarray(wd), jnp.asarray(bg), wgs)
    leaves = [_t(x, True), _t(wd, True), _t(bg, True), _t(wse, True)]
    got = eps.dil2_gated_block(*leaves)
    np.testing.assert_allclose(got.detach().numpy(), _from_bm(ref), **TOL)
    (got * _t(ct)).sum().backward()
    want = [_from_bm(jg[0]), np.asarray(jg[1]), np.asarray(jg[2]), _wse_grad(jg[3], co)]
    for leaf, r in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cis,gates", [((128,), 2), ((128, 128), 1)])
def test_phased_gated_block_matches_jax(cis, gates):
    """The phased block on the ungathered conv kernel: forward and the
    gradients of xs, w_all, b_all and the gate vectors against jax.grad
    through phased_gated_block_bm (K11 then K2 in the forward, the
    XLA-composition vjp)."""
    co, n = 16, 4
    xs, w_all, b_all = _phased_case(cis, co, seed=50 + len(cis))
    wse, wgs, oh = _gates(co, gates, 55)
    ct = _mk((2, n, n, n, 8 * co), 56)

    def jloss(w_, b_, wgs_, *xs_):
        return jnp.sum(jps.phased_gated_block_bm(xs_, w_, b_, wgs_, oh) * _bm(ct))

    jxs = [_bm(x) for x in xs]
    ref = jps.phased_gated_block_bm(tuple(jxs), jnp.asarray(w_all), jnp.asarray(b_all), wgs, oh)
    jg = jax.grad(jloss, tuple(range(3 + len(xs))))(jnp.asarray(w_all), jnp.asarray(b_all),
                                                     wgs, *jxs)
    leaves = [_t(w_all, True), _t(b_all, True), _t(wse, True)] + [_t(x, True) for x in xs]
    got = eps.phased_gated_block(leaves[3:], leaves[0], leaves[1], leaves[2], ext_kernel=True)
    np.testing.assert_allclose(got.detach().numpy(), _from_bm(ref), **TOL)
    (got * _t(ct)).sum().backward()
    want = [np.asarray(jg[0]), np.asarray(jg[1]), _wse_grad(jg[2], co)] + \
        [_from_bm(g) for g in jg[3:]]
    for leaf, r in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model_case():
    """Weights from one JAX init, the 16^3 batch-2 input, and the JAX
    conv-to-epilogue forward on it (one call: it takes the bulk of this
    file's time)."""
    jp = jax.jit(lambda k: init_params(k, JaxConfig()))(jax.random.key(4))
    jp = jax.tree.map(np.asarray, jp)
    model = SEUNet(SEUNetConfig())
    model.load_state_dict(state_dict_from_jax_params(jp))
    x = _mk((2, 16, 16, 16, 2), 70)
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith(("EPI_", "PALLAS_", "FASTPATH_BM", "DIL2_MODE", "UP_SLABS")):
                mp.delenv(k)
        mp.setenv("PALLAS_DIL2BM", "1")
        cfg = JaxConfig(batch_minor=True, use_pallas_epi=True)
        calls = {"dil2_conv_stats_bm": 0, "phased_conv_ext_bm": 0}
        for name in calls:
            orig = getattr(jps, name)

            def counted(*a, _orig=orig, _name=name):
                calls[_name] += 1
                return _orig(*a)
            mp.setattr(jps, name, counted)
        ref = jax.jit(lambda p, v: jax_apply_fast(p, v, cfg=cfg))(jp, jnp.asarray(x))
        ref = [np.asarray(r) for r in ref]
    return model, x, ref, calls


def test_apply_fast_conv_epi_matches_jax(model_case):
    model, x, ref, calls = model_case
    assert calls == {"dil2_conv_stats_bm": 3, "phased_conv_ext_bm": 5}
    with torch.inference_mode():
        got = se_unet_apply_fast(model.params_tree(), _t(x), cfg=SEUNetConfig(conv_epi=True))
    for g, r in zip(got, ref):
        assert g.shape == (2, 16, 16, 16, 1)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-3, atol=1e-4)


def test_apply_fast_conv_epi_matches_default(model_case):
    model, x, _, _ = model_case
    with torch.inference_mode():
        got = se_unet_apply_fast(model.params_tree(), _t(x), cfg=SEUNetConfig(conv_epi=True))
        ref = se_unet_apply_fast(model.params_tree(), _t(x), cfg=SEUNetConfig())
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-4)


def test_runner_conv_epi_matches_default(model_case):
    """Whole-volume probabilities of the conv_epi runner against the
    default one, cube 32, step 16, batch 2; the block-diagonal weights
    are built once, in the runner's `prepare_fast_params`."""
    model = model_case[0]
    vol = (np.random.default_rng(71).random((48, 40, 32)) * 1400 - 1000).astype(np.int16)
    kw = dict(cube=32, step=16, batch=2, device="cpu")
    ref = SlidingWindowRunner(model, SEUNetConfig(), **kw).predict_hu(vol, hu_shift=-24.0)
    runner = SlidingWindowRunner(model, SEUNetConfig(conv_epi=True), **kw)
    assert {"ec3", "ec5", "ec6"} <= {k for k, v in runner.fast_params.items()
                                     if isinstance(v, dict) and "wdense" in v}
    got = runner.predict_hu(vol, hu_shift=-24.0)
    assert got.shape == vol.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_conv_epi_with_conv_stats_raises():
    with pytest.raises(ValueError):
        SEUNetConfig(conv_epi=True, conv_stats=True)


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the new wrappers compute their plain versions and
    launch nothing."""
    xs, w_all, b_all = _phased_case((16, 8), 8, seed=80, b=1, n=3)
    x, wd, bg = _mk((1, 3, 3, 3, 16), 81), _mk((3, 3, 3, 16, 64), 82, 0.1), _mk((64,), 83)
    reset_launch_counts()
    pairs = [(pcs.dil2_dense_conv_stats(_t(x), _t(wd), _t(bg)),
              pcs.dil2_dense_conv_stats_plain(_t(x), _t(wd), _t(bg))),
             ((pcs.phased_conv_ungathered([_t(a) for a in xs], _t(w_all), _t(b_all)),),
              (pcs.phased_conv_ungathered_plain([_t(a) for a in xs], _t(w_all), _t(b_all)),))]
    for got, want in pairs:
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert {"dil2_dense_conv_stats", "phased_conv_ungathered"} <= set(launch_counts)
    assert not any(launch_counts.values())
