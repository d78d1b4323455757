"""The bf16 wgmma conv kernel's k-step table and skip rule on the CPU.

The kernel (csrc/conv_wgmma.cu) walks, per column tile, a list of k-steps
(64 lanes of one tap of one input, zero-filled past the input's width);
for the dense dil-2 conv (`dil2_dense_conv_stats`) the list holds only the
k-steps whose weight tile has a nonzero. `block_sparse_ksteps_plain`
evaluates the conv from those listed tiles alone, in f32. Here it is held
against the dense plain version and against the JAX Pallas kernel
`dil2_conv_stats_bm` in interpret mode (on the batch-minor layout it
takes, its lanes zero-padded to the multiple of 128 it needs), for the
block-diagonal weight the model passes, a dense weight, a weight with
random whole tiles zeroed, and C8 = 32 (a half-filled k-step); and the
table of a (32, 96) concat against the lanes it must cover. Float32, at
the tolerances of tests/test_torch_conv_epi.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_unet_airseg_tpu.ops import pallas_s2d as jps
from se_unet_airseg_tpu_torch.ops import conv_stats as pcs
from se_unet_airseg_tpu_torch.ops import s2d as ps2d

TOL = dict(rtol=1e-4, atol=2e-5)
N, B = 4, 2


def _mk(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _zero_tiles(wd, bn, keep_share, seed):
    """wd with whole (bn x 64) k-step tiles of its K-major form zeroed,
    each kept with probability keep_share."""
    c8, c8o = wd.shape[3], wd.shape[4]
    k = -(-c8 // 64)
    keep = np.random.default_rng(seed).random((c8o // bn, 27, k)) < keep_share
    mask = np.repeat(np.repeat(keep, bn, axis=0), 64, axis=2)[:, :, :c8]  # (C8o, 27, C8)
    return wd * mask.transpose(1, 2, 0).reshape(3, 3, 3, c8, c8o)


def _case(name):
    """(x, wd, bg) of one weight kind."""
    if name == "block_diagonal":  # ec3's widths: Ci 16, Co 32
        w = _mk((3, 3, 3, 16, 32), 2, 0.1)
        wd = ps2d.dil2_dense_weight(torch.from_numpy(w), torch.float32).numpy()
        return _mk((B, N, N, N, 128), 1), wd, np.tile(_mk((32,), 3, 0.1), 8)
    if name == "dense":
        return _mk((B, N, N, N, 128), 4), _mk((3, 3, 3, 128, 128), 5, 0.03), _mk((128,), 6, 0.1)
    if name == "tile_sparse":
        wd = _zero_tiles(_mk((3, 3, 3, 256, 128), 8, 0.03), pcs.dense_bn(256, 128), 0.4, 9)
        return _mk((B, N, N, N, 256), 7), wd, _mk((128,), 10, 0.1)
    assert name == "c8_32"  # one k-step per tap, 32 of its 64 lanes
    wd = _zero_tiles(_mk((3, 3, 3, 32, 128), 12, 0.1), pcs.dense_bn(32, 128), 0.5, 13)
    return _mk((B, N, N, N, 32), 11), wd, _mk((128,), 14, 0.1)


CASES = ["block_diagonal", "dense", "tile_sparse", "c8_32"]


@pytest.fixture(scope="module")
def jax_refs():
    """dil2_conv_stats_bm on every case, lanes zero-padded to a multiple
    of 128: y (B, n, n, n, C8o), s1, s2."""
    refs = {}
    for name in CASES:
        x, wd, bg = _case(name)
        pad = -x.shape[-1] % 128
        xp = np.pad(x, ((0, 0),) * 4 + ((0, pad),))
        wp = np.pad(wd, ((0, 0),) * 3 + ((0, pad), (0, 0)))
        out = jps.dil2_conv_stats_bm(jnp.asarray(np.moveaxis(xp, 0, 3)), jnp.asarray(wp),
                                     jnp.asarray(bg))
        assert out is not None  # the Pallas kernel ran, not a fallback
        refs[name] = (np.moveaxis(np.asarray(out[0]), 3, 0), np.asarray(out[1]),
                      np.asarray(out[2]))
    return refs


@pytest.mark.parametrize("name", CASES)
def test_block_sparse_ksteps_matches_dense_and_jax(name, jax_refs):
    x, wd, bg = (torch.from_numpy(np.ascontiguousarray(a)) for a in _case(name))
    got = pcs.block_sparse_ksteps_plain(x, wd, bg)
    ref = pcs.dil2_dense_conv_stats_plain(x, wd, bg)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-5)
    for g, r in zip(got[1:], ref[1:]):  # sums of f32 values summed in another order
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-3)
    y, s1, s2 = jax_refs[name]
    np.testing.assert_allclose(got[0].numpy(), y, **TOL)
    np.testing.assert_allclose(got[1].numpy(), s1, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), s2, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name", CASES)
def test_dense_ksteps_list_exactly_the_nonzero_tiles(name):
    """Each column tile's list starts with its nonzero k-steps in
    ascending K order, as many as its count; the rest are all-zero
    tiles."""
    _, wd, _ = _case(name)
    c8, c8o = wd.shape[3], wd.shape[4]
    bn = pcs.dense_bn(c8, c8o)
    wt = torch.from_numpy(np.ascontiguousarray(wd.transpose(4, 0, 1, 2, 3).reshape(c8o, 27 * c8)))
    steps, count = pcs.dense_ksteps(wt, c8, bn)
    tap, _, lane0, valid = pcs.kstep_fields(steps)
    for ct in range(c8o // bn):
        k = tap[ct] * c8 + lane0[ct]
        tiles = [bool(wt[ct * bn:(ct + 1) * bn, int(a):int(a + v)].any())
                 for a, v in zip(k, valid[ct])]
        c = int(count[ct])
        assert tiles == [True] * c + [False] * (len(tiles) - c)
        assert bool((k[1:c] > k[:c - 1]).all())
        assert sorted(k.tolist()) == [t * c8 + a for t in range(27) for a in range(0, c8, 64)]


@pytest.mark.parametrize("c8,c8o,bn,share", [(128, 256, 128, 1 / 2), (256, 256, 64, 1 / 4),
                                             (256, 512, 128, 1 / 4)])
def test_dense_bn_on_the_model_widths(c8, c8o, bn, share):
    """ec3, ec5, ec6: the column tile that lines up with the
    block-diagonal weight's sub-position blocks, and the share of k-step
    tiles it executes."""
    w = torch.from_numpy(_mk((3, 3, 3, c8 // 8, c8o // 8), c8 + c8o))
    wd = ps2d.dil2_dense_weight(w, torch.float32)
    assert pcs.dense_bn(c8, c8o) == bn
    _, count = pcs.dense_ksteps(wd.permute(4, 0, 1, 2, 3).reshape(c8o, 27 * c8), c8, bn)
    assert int(count.sum()) == share * count.numel() * 27 * c8 // 64


def test_zero_weight_and_a_nan_in_a_skipped_lane():
    """An all-zero weight lists no k-step: y is the bias. A NaN of x in a
    lane whose weight tiles are all zero reaches y in the dense plain
    version and not through the listed tiles (the documented difference
    from the dense TPU kernel)."""
    x, wd, bg = (torch.from_numpy(np.ascontiguousarray(a)) for a in _case("block_diagonal"))
    zero = torch.zeros_like(wd)
    _, count = pcs.dense_ksteps(zero.permute(4, 0, 1, 2, 3).reshape(256, 27 * 128), 128, 128)
    assert not bool(count.any())
    y, s1, _ = pcs.block_sparse_ksteps_plain(x, zero, bg)
    torch.testing.assert_close(y, bg.expand_as(y), rtol=0, atol=0)
    torch.testing.assert_close(s1, N ** 3 * bg.expand(B, 256), rtol=1e-6, atol=1e-5)
    x[0, 1, 1, 1, 0] = float("nan")  # lane 0: sub-position 0, column tile 0 only
    assert bool(torch.isfinite(pcs.block_sparse_ksteps_plain(x, wd, bg)[0][..., 128:]).all())
    assert not bool(torch.isfinite(pcs.dil2_dense_conv_stats_plain(x, wd, bg)[0][..., 128:]).all())


@pytest.mark.parametrize("taps,widths", [(8, (32, 96)), (8, (64, 192)), (27, (32,)), (27, (256,))])
def test_kstep_table_covers_the_input_lanes(taps, widths):
    """Every lane of every input at every tap in exactly one k-step, at
    most 64 lanes a k-step in whole 8-lane chunks, in ascending K order
    (K = tap * Cin + lane of the concat)."""
    tap, inp, lane0, valid = pcs.kstep_fields(pcs.kstep_table(taps, widths))
    assert bool(((valid > 0) & (valid <= 64) & (valid % 8 == 0) & (lane0 % 64 == 0)).all())
    offs = np.cumsum((0,) + widths)
    k = tap * offs[-1] + torch.tensor(offs)[inp] + lane0
    assert bool((k[1:] > k[:-1]).all())
    for t in range(taps):
        for i, c in enumerate(widths):
            sel = (tap == t) & (inp == i)
            lanes = sorted(a for l0, v in zip(lane0[sel], valid[sel]) for a in range(l0, l0 + v))
            assert lanes == list(range(c))
    if widths == (32, 96):  # per tap: 32 lanes of x0, then 64 + 32 of x1
        assert valid[:3].tolist() == [32, 64, 32] and lane0[:3].tolist() == [0, 0, 64]
