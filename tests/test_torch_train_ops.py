"""The port's train-path ops against the JAX package's, on the CPU.

* K5's plain version (`phased_normalize_plain`) against the Pallas
  `phased_normalize` in interpret mode; K6's plain version, mask form,
  against the Pallas `max_pool_s2d_bwd_mask`, and fused form against
  `jax.vjp` of the JAX `max_pool_s2d` (its default "concat" backward).
  Inputs carry planted ties, since only ties show the split.
* The epilogue backwards (`_gated_core_bwd`, `_manual_phased_gated_bwd`)
  against the JAX hand-written ones (exact_doh=False) and against
  `jax.vjp` of the XLA compositions, at the tolerances of
  tests/test_manual_bwd.py; the port's compact gate gradient d_wse (G, C)
  against the JAX padded dwgs (G, 8C, 128) folded back.
* `torch.autograd.gradcheck` in float64 of the three autograd Functions.

Same numpy inputs on both sides; float32 unless stated. The kernels
themselves run only on the card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_unet_airseg_tpu.ops import pallas_s2d as jps
from se_unet_airseg_tpu.ops.s2d import (
    max_pool_s2d as jax_max_pool_s2d,
    phased_conv_weights as jax_phased_conv_weights,
    se_gate_weights as jax_se_gate_weights,
)
from se_unet_airseg_tpu_torch.ops import epilogue_s2d as eps
from se_unet_airseg_tpu_torch.ops import launch_counts, reset_launch_counts
from se_unet_airseg_tpu_torch.ops import s2d as ps2d

BWD_RTOL, BWD_ATOL = 2e-4, 2e-5  # tests/test_manual_bwd.py


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gates(r, co, gates):
    """Compact (G, C) gate vectors and the JAX padded (wgs, oh); G = 0
    gives zero-size JAX arrays, which both JAX backwards take."""
    wse = (r.standard_normal((gates, co)) * 0.2).astype(np.float32)
    wgs, oh = [], jnp.zeros((128, 8 * co), jnp.float32)
    for g in range(gates):
        wg, oh_ = jax_se_gate_weights(jnp.asarray(wse[g][:, None]), jnp.float32)
        wgs.append(jnp.pad(wg, ((0, 0), (0, 128 - wg.shape[1]))))
        oh = jnp.pad(oh_, ((0, 128 - oh_.shape[0]), (0, 0)))
    wgs = jnp.stack(wgs) if gates else jnp.zeros((0, 8 * co, 128), jnp.float32)
    return wse, wgs, oh


def _fold_dwgs(dwgs, co):
    """JAX (G, 8C, 128) gate-kernel cotangent -> the compact (G, C) one:
    d_wse[g, c] = sum_p dwgs[g, p*C + c, p]."""
    d = np.asarray(dwgs)[:, :, :8].reshape(-1, 8, co, 8)
    return np.einsum("gpcp->gc", d)


def _close(got, ref, rtol=BWD_RTOL, atol=BWD_ATOL, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=name)


def _with_ties(r, shape, dtype=np.float32):
    """Random x (..., 8C) with ties planted among the 8 sub-positions:
    for a third of the (voxel, channel) pairs, sub-position blocks 3 and
    6 copy block 1 (the maximum or not), and for another third every
    block holds one value."""
    c = shape[-1] // 8
    x = r.standard_normal(shape).astype(dtype)
    x8 = x.reshape(*shape[:-1], 8, c)
    pick = r.random((*shape[:-1], c))
    x8[..., 3, :] = np.where(pick < 1 / 3, x8[..., 1, :], x8[..., 3, :])
    x8[..., 6, :] = np.where(pick < 1 / 3, x8[..., 1, :], x8[..., 6, :])
    x8[:] = np.where((pick > 2 / 3)[..., None, :], x8[..., :1, :], x8)
    return x8.reshape(shape)


# ------------------------------------------------------------ K5, K6


def test_phased_normalize_plain_matches_pallas():
    r = np.random.default_rng(0)
    b, n, co, xw = 2, 8, 16, 16  # x extent n+1 = 9 padded to 8, as the JAX conv emits it
    y_ext = r.standard_normal((b, n + 1, n + 1, xw, 8 * co)).astype(np.float32)
    scale8 = (0.5 + r.random((b, 8 * co))).astype(np.float32)
    shift8 = (r.standard_normal((b, 8 * co)) * 0.3).astype(np.float32)
    ref = jps.phased_normalize(jnp.asarray(y_ext), jnp.asarray(scale8), jnp.asarray(shift8))
    assert ref is not None  # the Pallas kernel ran, not a fallback
    got = eps.phased_normalize_plain(_t(y_ext), _t(scale8), _t(shift8))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("c8", [128, 256])
def test_pool_mask_plain_matches_pallas(c8):
    """Exact, ties included (the Pallas entry needs 8C % 128 == 0)."""
    x = _with_ties(np.random.default_rng(c8), (2, 4, 4, 4, c8))
    ref = jps.max_pool_s2d_bwd_mask(jnp.asarray(x))
    assert ref is not None
    got = ps2d.max_pool_s2d_bwd_plain(_t(x))
    assert {1.0, float(np.float32(1 / 3)), 0.125} <= set(np.unique(got.numpy()).tolist())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("c8", [16, 128, 256])
def test_pool_backward_matches_jax_vjp(c8, dtype):
    """dx of the port's max_pool_s2d (its Function's backward, the fused
    kernel form on the card) against jax.vjp of the JAX max_pool_s2d:
    exact, ties included."""
    r = np.random.default_rng(c8 + 1)
    x = _with_ties(r, (2, 4, 4, 4, c8)).astype(dtype)
    g = r.standard_normal((2, 4, 4, 4, c8 // 8)).astype(dtype)
    out, vjp = jax.vjp(jax_max_pool_s2d, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    xt = _t(x.astype(np.float32)).to(tdt).requires_grad_(True)
    y = ps2d.max_pool_s2d(xt)
    np.testing.assert_array_equal(y.detach().float().numpy(), np.asarray(out, np.float32))
    y.backward(_t(g.astype(np.float32)).to(tdt))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(ref, np.float32))


def test_new_wrappers_take_plain_version_on_cpu():
    r = np.random.default_rng(3)
    y_ext = _t(r.standard_normal((2, 5, 5, 5, 64)).astype(np.float32))
    scale8 = _t((0.5 + r.random((2, 64))).astype(np.float32))
    shift8 = _t(r.standard_normal((2, 64)).astype(np.float32))
    x = _t(_with_ties(r, (2, 3, 3, 3, 24)))
    g = _t(r.standard_normal((2, 3, 3, 3, 3)).astype(np.float32))
    reset_launch_counts()
    torch.testing.assert_close(eps.phased_normalize(y_ext, scale8, shift8),
                               eps.phased_normalize_plain(y_ext, scale8, shift8),
                               rtol=0, atol=0)
    for gg in (None, g):
        torch.testing.assert_close(ps2d.max_pool_s2d_bwd(x, gg),
                                   ps2d.max_pool_s2d_bwd_plain(x, gg), rtol=0, atol=0)
    assert not any(launch_counts.values())


# ---------------------------------------------------------- backwards


@pytest.mark.parametrize("gates", [0, 1, 2])
def test_gated_backward_matches_jax(gates):
    r = np.random.default_rng(10 + gates)
    b, n, co = 2, 6, 4
    y = r.standard_normal((b, n, n, n, 8 * co)).astype(np.float32)
    ct = r.standard_normal((b, n, n, n, 8 * co)).astype(np.float32)
    wse, wgs, oh = _gates(r, co, gates)
    manual = jps._gated_core_bwd(jnp.asarray(y), wgs, oh, jnp.asarray(ct), bm=False)
    _, vjp = jax.vjp(jps._xla_gated_norm_composition, jnp.asarray(y), wgs, oh)
    comp = vjp(jnp.asarray(ct))
    dy, d_wse = eps._gated_core_bwd(_t(y), _t(wse) if gates else None, _t(ct))
    for ref in (manual, comp):
        _close(dy, ref[0], name="dy")
        if gates:
            _close(d_wse, _fold_dwgs(ref[1], co), name="d_wse")
    # the Function's backward is this function
    yt = _t(y).requires_grad_(True)
    wt = _t(wse).requires_grad_(True) if gates else None
    eps.gated_norm_block(yt, wt).backward(_t(ct))
    torch.testing.assert_close(yt.grad, dy, rtol=0, atol=0)


@pytest.mark.parametrize("gates,cis", [(0, (16,)), (1, (32,)), (2, (16, 8))])
def test_phased_backward_matches_jax(gates, cis):
    r = np.random.default_rng(20 + gates)
    b, n, co = 2, 6, 4
    xs = [r.standard_normal((b, n, n, n, c)).astype(np.float32) for c in cis]
    w = (r.standard_normal((3, 3, 3, sum(cis) // 8, co)) * 0.3).astype(np.float32)
    bias = r.standard_normal(co).astype(np.float32)
    splits = tuple(c // 8 for c in cis) if len(cis) > 1 else None
    ct = r.standard_normal((b, n, n, n, 8 * co)).astype(np.float32)
    wse, wgs, oh = _gates(r, co, gates)
    jw, jb = jax_phased_conv_weights(jnp.asarray(w), jnp.asarray(bias), splits)
    jxs = tuple(jnp.asarray(x) for x in xs)
    manual = jps._manual_phased_gated_bwd((jxs, jw, jb, wgs, oh), jnp.asarray(ct))
    _, vjp = jax.vjp(jps._xla_gated_composition, jxs, jw, jb, wgs, oh)
    comp = vjp(jnp.asarray(ct))
    pw, pb = (_t(np.array(a)) for a in (jw, jb))
    dxs, dw, db, d_wse = eps._manual_phased_gated_bwd(
        [_t(x) for x in xs], pw, pb, _t(wse) if gates else None, _t(ct))
    for ref in (manual, comp):
        for got, want in zip(dxs, ref[0]):
            _close(got, want, name="dxs")
        _close(dw, ref[1], name="dw_all")
        _close(db, ref[2], name="db_all", atol=1e-4)  # sums of 8n^3 terms near 0
        if gates:
            _close(d_wse, _fold_dwgs(ref[3], co), name="d_wse")


def _gradcheck_inputs(kind, r):
    d = torch.float64
    if kind == "pool":
        return ps2d.max_pool_s2d, [torch.randn(2, 3, 3, 3, 16, dtype=d, generator=r)]
    gates = int(kind[-1])
    wse = [0.3 * torch.randn(gates, 2, dtype=d, generator=r)] if gates else []
    if kind.startswith("gathered"):
        y = torch.randn(2, 3, 3, 3, 16, dtype=d, generator=r)
        return (lambda y, *w: eps.gated_norm_block(y, *w)), [y, *wse]
    cis = (16,) if gates == 1 else (16, 8)
    n = 2
    xs = [torch.randn(2, n, n, n, c, dtype=d, generator=r) for c in cis]
    w = 0.3 * torch.randn(3, 3, 3, sum(cis) // 8, 2, dtype=d, generator=r)
    w_all, b_all = ps2d.phased_conv_weights(
        w, torch.randn(2, dtype=d, generator=r),
        tuple(c // 8 for c in cis) if len(cis) > 1 else None)
    k = len(xs)
    return ((lambda *a: eps.phased_gated_block(a[:k], a[k], a[k + 1], a[k + 2])),
            [*xs, w_all, b_all, *wse])


@pytest.mark.parametrize("kind", ["gathered0", "gathered1", "gathered2", "phased1",
                                  "phased2", "pool"])
def test_autograd_functions_gradcheck(kind):
    """The hand-written backwards are the exact gradients of the forwards
    (float64, central differences)."""
    fn, inputs = _gradcheck_inputs(kind, torch.Generator().manual_seed(len(kind)))
    inputs = [t.requires_grad_(True) for t in inputs]
    assert torch.autograd.gradcheck(fn, inputs, fast_mode=True)
