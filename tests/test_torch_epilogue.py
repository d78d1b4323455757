"""The port's fused epilogue (ops/epilogue_s2d.py) against the JAX
package's Pallas epilogue kernels, which run in interpret mode on CPU.

The plain versions of the two CUDA kernels are held against both Pallas
entry points of their computation (gathered: gated_norm_finalize and
gated_norm_finalize_bm; phased: phased_finalize and phased_finalize_bm),
and the block functions against the JAX blocks. Same numpy inputs on
both sides; float32 at atol=2e-6, rtol=1e-5 (tests/test_pallas_epi.py).
The kernels themselves run only on the card (tests/test_torch_cuda.py)."""

from itertools import product

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_unet_airseg_tpu.ops import pallas_s2d as jps
from se_unet_airseg_tpu.ops.s2d import (
    phased_conv_weights as jax_phased_conv_weights,
    se_gate_weights as jax_se_gate_weights,
)
from se_unet_airseg_tpu_torch.ops import epilogue_s2d as eps
from se_unet_airseg_tpu_torch.ops import launch_counts, reset_launch_counts
from se_unet_airseg_tpu_torch.ops.s2d import phased_conv_weights

ATOL, RTOL = 2e-6, 1e-5


def _gates(r, co, gates):
    """Compact (G, C) gate vectors and the JAX padded (wgs, oh)."""
    wse = r.standard_normal((gates, co)).astype(np.float32) * 0.1
    if not gates:
        return wse, None, None
    wgs, oh = [], None
    for g in range(gates):
        wg, oh_ = jax_se_gate_weights(jnp.asarray(wse[g][:, None]), jnp.float32)
        wgs.append(jnp.pad(wg, ((0, 0), (0, 128 - wg.shape[1]))))
        oh = jnp.pad(oh_, ((0, 128 - oh_.shape[0]), (0, 0)))
    return wse, jnp.stack(wgs), oh


def _affine(r, b, c8):
    scale8 = (0.5 + r.random((b, c8))).astype(np.float32)
    shift8 = r.standard_normal((b, c8)).astype(np.float32) * 0.3
    return scale8, shift8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_wse(wse):
    return _t(wse) if wse.shape[0] else None


@pytest.mark.parametrize("gates", [0, 1, 2])
def test_gathered_plain_matches_gated_norm_finalize(gates):
    r = np.random.default_rng(gates)
    b, n, co = 2, 8, 16
    y = r.standard_normal((b, n, n, n, 8 * co)).astype(np.float32)
    scale8, shift8 = _affine(r, b, 8 * co)
    wse, wgs, oh = _gates(r, co, gates)
    ref = jps.gated_norm_finalize(jnp.asarray(y), jnp.asarray(scale8),
                                  jnp.asarray(shift8), wgs, oh)
    assert ref is not None  # the Pallas kernel ran, not a fallback
    got = eps.gathered_epilogue_plain(_t(y), _t(scale8), _t(shift8), _port_wse(wse))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("gates", [0, 1, 2])
def test_gathered_plain_matches_gated_norm_finalize_bm(gates):
    r = np.random.default_rng(10 + gates)
    b, n, co = 8, 4, 16
    y = r.standard_normal((b, n, n, n, 8 * co)).astype(np.float32)
    scale8, shift8 = _affine(r, b, 8 * co)
    wse, wgs, oh = _gates(r, co, gates)
    ref = jps.gated_norm_finalize_bm(jnp.asarray(y.transpose(1, 2, 3, 0, 4)),
                                     jnp.asarray(scale8), jnp.asarray(shift8), wgs, oh)
    assert ref is not None
    got = eps.gathered_epilogue_plain(_t(y), _t(scale8), _t(shift8), _port_wse(wse))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(3, 0, 1, 2, 4),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("gates", [1, 2])
def test_phased_plain_matches_phased_finalize(gates):
    """Batch-major K4 form: the x extent is padded to a multiple of 8,
    as the JAX phased conv emits it; the port reads it through strides."""
    r = np.random.default_rng(20 + gates)
    b, n, co = 2, 8, 16
    xw = 16  # n+1 = 9 rounded up to 8
    y_ext = r.standard_normal((b, n + 1, n + 1, xw, 8 * co)).astype(np.float32)
    scale8, shift8 = _affine(r, b, 8 * co)
    wse, wgs, oh = _gates(r, co, gates)
    ref = jps.phased_finalize(jnp.asarray(y_ext), jnp.asarray(scale8),
                              jnp.asarray(shift8), wgs, oh)
    assert ref is not None
    got = eps.phased_epilogue_plain(_t(y_ext), _t(scale8), _t(shift8), _port_wse(wse))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("gates", [0, 1, 2])
def test_phased_plain_matches_phased_finalize_bm(gates):
    r = np.random.default_rng(30 + gates)
    b, n, co = 8, 4, 16
    y_ext = r.standard_normal((b, n + 1, n + 1, n + 1, 8 * co)).astype(np.float32)
    scale8, shift8 = _affine(r, b, 8 * co)
    wse, wgs, oh = _gates(r, co, gates)
    ref = jps.phased_finalize_bm(jnp.asarray(y_ext.transpose(1, 2, 3, 0, 4)),
                                 jnp.asarray(scale8), jnp.asarray(shift8), wgs, oh)
    assert ref is not None
    got = eps.phased_epilogue_plain(_t(y_ext), _t(scale8), _t(shift8), _port_wse(wse))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(3, 0, 1, 2, 4),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,gates", [(2, 0), (2, 1), (8, 2)])
def test_gated_norm_block_matches_jax(b, gates):
    """Statistics + gathered epilogue: B=2 reaches K3, B=8 K1 (tbm)."""
    r = np.random.default_rng(40 + b + gates)
    n, co = 8, 16
    y = (r.standard_normal((b, n, n, n, 8 * co)) * 2 + 0.5).astype(np.float32)
    wse, wgs, oh = _gates(r, co, gates)
    ref = jps.gated_norm_block_tbm(jnp.asarray(y), wgs, oh)
    got = eps.gated_norm_block(_t(y), _port_wse(wse))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("b,cis,gates", [(2, (128,), 1), (2, (64, 64), 2),
                                         (8, (64, 64), 1), (2, (16, 24), 1),
                                         (2, (16, 24), 2)])
def test_phased_gated_block_matches_jax(b, cis, gates):
    """Phased conv + window statistics + phased epilogue: B=2 reaches K4
    (through phased_gated_block), B=8 K2 (through the tbm block); the
    (16, 24) cases a concat of two unequal inputs."""
    r = np.random.default_rng(50 + b + gates)
    n, co = 8, 16
    w = r.standard_normal((3, 3, 3, sum(cis) // 8, co)).astype(np.float32) * 0.1
    bias = r.standard_normal(co).astype(np.float32) * 0.1
    splits = tuple(c // 8 for c in cis) if len(cis) > 1 else None
    xs = [r.standard_normal((b, n, n, n, c)).astype(np.float32) for c in cis]
    wse, wgs, oh = _gates(r, co, gates)
    jw, jb = jax_phased_conv_weights(jnp.asarray(w), jnp.asarray(bias), splits)
    block = jps.phased_gated_block if b % 8 else jps.phased_gated_block_tbm
    ref = block(tuple(jnp.asarray(x) for x in xs), jw, jb, wgs, oh)
    pw, pb = phased_conv_weights(_t(w), _t(bias), splits)
    got = eps.phased_gated_block([_t(x) for x in xs], pw, pb, _port_wse(wse))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the wrappers are their plain versions and launch
    nothing."""
    r = np.random.default_rng(60)
    y = _t(r.standard_normal((2, 4, 4, 4, 64)).astype(np.float32))
    y_ext = _t(r.standard_normal((2, 5, 5, 5, 64)).astype(np.float32))
    scale8, shift8 = (_t(a) for a in _affine(r, 2, 64))
    wse = _t(r.standard_normal((2, 8)).astype(np.float32))
    reset_launch_counts()
    torch.testing.assert_close(eps.gathered_epilogue(y, scale8, shift8, wse),
                               eps.gathered_epilogue_plain(y, scale8, shift8, wse),
                               rtol=0, atol=0)
    torch.testing.assert_close(eps.phased_epilogue(y_ext, scale8, shift8, wse),
                               eps.phased_epilogue_plain(y_ext, scale8, shift8, wse),
                               rtol=0, atol=0)
    assert {"gathered_epilogue", "phased_epilogue"} <= set(launch_counts)
    assert not any(launch_counts.values())


def test_phase_windows_match_gather_definition():
    """Phase q = (a, b, c) of voxel (z, y, x) is y_ext[z+a, y+b, x+c] in
    lane block q — the addressing the phased kernel implements."""
    r = np.random.default_rng(61)
    n, co = 3, 2
    y_ext = r.standard_normal((1, n + 1, n + 1, n + 1, 8 * co)).astype(np.float32)
    one = np.ones((1, 8 * co), np.float32)
    got = eps.phased_epilogue_plain(_t(y_ext), _t(one), _t(0 * one)).numpy()
    want = np.empty((1, n, n, n, 8 * co), np.float32)
    for q, (a, b, c) in enumerate(product(range(2), repeat=3)):
        for z, yy, x in product(range(n), repeat=3):
            v = y_ext[0, z + a, yy + b, x + c, q * co : (q + 1) * co]
            want[0, z, yy, x, q * co : (q + 1) * co] = np.where(v >= 0, v, 0.01 * v)
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)

