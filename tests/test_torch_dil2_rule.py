"""The bf16 dil-2 kernel's brick rule and tile chooser on the CPU.

The kernel (csrc/dil2_wgmma.cu) computes `dil2_conv_stats` in bricks of 8 x
ty x tz output voxels, each from its zero-filled (tz+2) x (ty+2) x 10 halo
brick, and `bn` output columns a block (`dil2_tile`, from the widths alone).
`dil2_brick_plain` states that rule in f32. Here it is held against the
plain version `dil2_conv_stats_plain` and against the JAX `dil2_conv_stats`
(its Pallas kernel in interpret mode at n = 6; at n = 5, which no tile of
the TPU kernel divides, JAX's own XLA composition), at n = 5 and 6, which
no brick divides, and batch 3: y at rtol 1e-5 in f32, the sums at
the tolerances of tests/test_torch_conv_stats.py, and bf16 y within one
ulp plus the f32 reordering floor (the `_conv_stats_close` rule of
tests/test_torch_cuda.py). The tile chooser is held to fit the shared
memory at the model's shapes and at every test shape."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_unet_airseg_tpu.ops import pallas_s2d as jps
from se_unet_airseg_tpu_torch.ops import conv_stats as pcs

Y_TOL = dict(rtol=1e-5, atol=1e-5)
S_TOL = dict(rtol=1e-4, atol=1e-3)
B = 3
WIDTHS = [(8, 8), (16, 32), (32, 64)]
CASES = [(n, ci, co) for n in (5, 6) for ci, co in WIDTHS]
# (Ci, Co) of the three dil-2 calls of chip_smoke.py's CS_DIL2 (ec3, ec5,
# ec6), and the tile (ty, tz, bn) each takes
MODEL_TILES = {(16, 32): (4, 2, 32), (32, 32): (4, 2, 32), (32, 64): (2, 2, 64)}
# widths of the card tests (tests/test_torch_cuda.py)
CARD_WIDTHS = [(8, 8), (8, 24), (16, 32), (32, 64), (64, 64), (112, 16), (24, 48), (16, 48)]
SMEM_BLOCK = 232448


def _mk(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _case(n, ci, co):
    """x, the reference dil-2 kernel at the model's scale (1 / sqrt(27 Ci):
    y of order one) and the bias."""
    seed = 100 * n + ci + co
    return (_mk((B, n, n, n, 8 * ci), seed), _mk((3, 3, 3, ci, co), seed + 1, (27 * ci) ** -0.5),
            _mk((co,), seed + 2, 0.1))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def jax_refs():
    """JAX dil2_conv_stats on every case: y, s1, s2."""
    refs = {}
    for case in CASES:
        x, w, b = _case(*case)
        out = jps.dil2_conv_stats(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        refs[case] = tuple(np.asarray(t) for t in out)
    return refs


@pytest.mark.parametrize("case", CASES, ids=[f"n{n}-ci{ci}-co{co}" for n, ci, co in CASES])
def test_brick_rule_matches_plain_and_jax(case, jax_refs):
    x, w, b = (_t(a) for a in _case(*case))
    got = pcs.dil2_brick_plain(x, w, b)
    ref = pcs.dil2_conv_stats_plain(x, w, b)
    torch.testing.assert_close(got[0], ref[0], **Y_TOL)
    for g, r in zip(got[1:], ref[1:]):  # sums of f32 values summed in another order
        torch.testing.assert_close(g, r, **S_TOL)
    y, s1, s2 = jax_refs[case]
    np.testing.assert_allclose(got[0].numpy(), y, **Y_TOL)
    np.testing.assert_allclose(got[1].numpy(), s1, **S_TOL)
    np.testing.assert_allclose(got[2].numpy(), s2, **S_TOL)


@pytest.mark.parametrize("case", CASES, ids=[f"n{n}-ci{ci}-co{co}" for n, ci, co in CASES])
def test_brick_rule_bf16_within_one_ulp(case):
    """bf16 inputs: the rule's y, rounded once from its f32 sum, within
    one ulp of the plain version's plus 2^-18 of the sum of |terms|; the
    sums within 1e-4 of each lane's sum of |y| and y^2."""
    x, w, b = _case(*case)
    x, w = _t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16)
    b = _t(b)
    (y, s1, s2), (ry, r1, r2) = pcs.dil2_brick_plain(x, w, b), pcs.dil2_conv_stats_plain(x, w, b)
    assert y.dtype == ry.dtype == torch.bfloat16
    mag = pcs.dil2_conv_stats_plain(x.abs(), w.abs(), 0 * b)[0].float()
    r = ry.float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    assert bool(((y.float() - r).abs() <= ulp + 2.0 ** -18 * mag).all())
    for s, rs, m in ((s1, r1, r.abs()), (s2, r2, r.square())):
        assert bool(((s - rs).abs() <= 1e-4 * m.sum(dim=(1, 2, 3)) + 1e-6).all())


@pytest.mark.parametrize("ty,tz", [(1, 1), (2, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("bn", [8, 16, 32])
def test_brick_rule_is_one_function_over_every_tile(ty, tz, bn):
    """Every split of the voxels and the columns over blocks gives the
    plain version's values, at a ragged n of 7."""
    x, w, b = (_t(a) for a in (_mk((1, 7, 7, 7, 64), 1), _mk((3, 3, 3, 8, 32), 2, 0.2),
                               _mk((32,), 3, 0.1)))
    got = pcs.dil2_brick_plain(x, w, b, (ty, tz, bn))
    ref = pcs.dil2_conv_stats_plain(x, w, b)
    torch.testing.assert_close(got[0], ref[0], **Y_TOL)
    for g, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(g, r, **S_TOL)


@pytest.mark.parametrize("ci,co", sorted(set(WIDTHS) | set(MODEL_TILES) | set(CARD_WIDTHS)))
def test_tile_fits_shared_memory(ci, co):
    """The brick plus the weight's column tile fit in 227 KB; bn divides
    Co; the model's shapes take the tiles the kernel was sized for."""
    ty, tz, bn, smem = pcs.dil2_tile(ci, co)
    assert (ty, tz) in pcs._DIL2_BRICKS and co % bn == 0 and bn in (8, 16, 32, 64)
    assert smem == pcs.dil2_smem(ci, ty, tz, bn) <= SMEM_BLOCK
    weight, brick = pcs._dil2_kp(ci) * bn * 2, 10 * (ty + 2) * (tz + 2) * 16 * ci
    assert weight + brick < smem
    if (ci, co) in MODEL_TILES:
        assert (ty, tz, bn) == MODEL_TILES[(ci, co)]


def test_tile_refuses_what_does_not_fit():
    """Ci = 112 fits with the smallest brick and a column tile of 8; Ci
    = 120 fits nowhere, and widths that are not multiples of 8 are
    refused."""
    assert pcs.dil2_tile(112, 8)[:3] == (1, 1, 8)
    for ci, co in ((120, 8), (12, 32), (16, 20)):
        with pytest.raises(ValueError):
            pcs.dil2_tile(ci, co)
