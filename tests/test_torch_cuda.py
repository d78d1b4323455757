"""The port's CUDA kernels on the card, against their plain versions, and
the runner's overlap count built on the card against the host loop.

Every test here needs a CUDA device and nvcc and is marked `cuda`; on a
CPU-only host each skips. This file imports no JAX, so it also runs on
the GPU host, which has none:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest`: tests/conftest.py sets up JAX, which that host lacks.)
"""

import numpy as np
import pytest
import torch

from se_unet_airseg_tpu_torch.data import pad_positions_to_batch, tile_positions
from se_unet_airseg_tpu_torch.infer.sliding_window import inv_overlap_count
from se_unet_airseg_tpu_torch.models import SEUNet, SEUNetConfig, se_unet_apply_fast
from se_unet_airseg_tpu_torch.models.se_unet import _leaves, _tree_map
from se_unet_airseg_tpu_torch.ops import conv_stats as pcs
from se_unet_airseg_tpu_torch.ops import epilogue_s2d as eps
from se_unet_airseg_tpu_torch.ops import (
    build_kernels,
    launch_counts,
    norm_leaky,
    reset_launch_counts,
)
from se_unet_airseg_tpu_torch.ops import s2d as ps2d
from se_unet_airseg_tpu_torch.train import make_loss_fn

pytestmark = pytest.mark.cuda

# bf16: the kernel keeps the plain version's rounding points; only the
# gate logits sum in another order (a flipped gate moves a product by an
# ulp or two)
TOL = {torch.float32: dict(atol=1e-6, rtol=1e-5),
       torch.bfloat16: dict(atol=2 ** -12, rtol=2 ** -5)}


@pytest.fixture
def dev():
    """The card; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _counts(**nonzero):
    """Every kernel's launch count: `nonzero`, 0 for the others."""
    return {k: nonzero.get(k, 0) for k in launch_counts}


def _inputs(dev, dtype, b, m, c8, gates, xw=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn((b, m, m, xw or m, c8), generator=g, device=dev).to(dtype)
    scale8 = 0.5 + torch.rand((b, c8), generator=g, device=dev)
    shift8 = 0.3 * torch.randn((b, c8), generator=g, device=dev)
    wse = (0.1 * torch.randn((gates, c8 // 8), generator=g, device=dev)).to(dtype) \
        if gates else None
    return y, scale8, shift8, wse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c8,gates", [(2, 8, 64, 1), (3, 4, 128, 0), (8, 8, 256, 2),
                                          (1, 16, 512, 2)])
def test_gathered_kernel_matches_plain(dev, dtype, b, n, c8, gates):
    y, scale8, shift8, wse = _inputs(dev, dtype, b, n, c8, gates)
    reset_launch_counts()
    got = eps.gathered_epilogue(y, scale8, shift8, wse)
    torch.cuda.synchronize()
    assert launch_counts["gathered_epilogue"] == 1
    torch.testing.assert_close(got, eps.gathered_epilogue_plain(y, scale8, shift8, wse),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c8,gates,xw", [(2, 8, 128, 1, None), (2, 8, 128, 2, 16),
                                             (8, 4, 256, 2, None), (1, 16, 512, 1, 24)])
def test_phased_kernel_matches_plain(dev, dtype, b, n, c8, gates, xw):
    """xw > n+1: the padded x extent of a batch-major conv output, read
    through the strides."""
    y, scale8, shift8, wse = _inputs(dev, dtype, b, n + 1, c8, gates, xw=xw, seed=1)
    reset_launch_counts()
    got = eps.phased_epilogue(y, scale8, shift8, wse)
    torch.cuda.synchronize()
    assert launch_counts["phased_epilogue"] == 1
    assert got.shape == (b, n, n, n, c8)
    torch.testing.assert_close(got, eps.phased_epilogue_plain(y, scale8, shift8, wse),
                               **TOL[dtype])


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    y, scale8, shift8, wse = _inputs(dev, torch.float32, 2, 4, 64, 1)
    with pytest.raises(ValueError):
        eps.gathered_epilogue(y.transpose(1, 2), scale8, shift8, wse)
    with pytest.raises(ValueError):
        eps.gathered_epilogue(y, scale8[:, :32], shift8, wse)
    with pytest.raises(TypeError):
        eps.gathered_epilogue(y.half(), scale8, shift8, None)
    with pytest.raises(ValueError):
        eps.gathered_epilogue(y[..., :24].contiguous(), scale8[:, :24].contiguous(),
                              shift8[:, :24].contiguous(), None)


def test_apply_fast_on_card_matches_cpu(dev):
    cfg = SEUNetConfig()
    model = SEUNet(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, 32, 32, 2), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = se_unet_apply_fast(model.params_tree(), x, cfg=cfg)
        reset_launch_counts()
        got = se_unet_apply_fast(model.to(dev).params_tree(), x.to(dev), cfg=cfg)
    assert launch_counts == _counts(gathered_epilogue=10, phased_epilogue=5, norm_stats=15)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c8,xw", [(2, 8, 128, None), (8, 4, 256, 16), (1, 16, 512, None)])
def test_phased_normalize_kernel_matches_plain(dev, dtype, b, n, c8, xw):
    """One rounding point, the same as the plain version's: exact."""
    y, scale8, shift8, _ = _inputs(dev, dtype, b, n + 1, c8, 0, xw=xw, seed=2)
    reset_launch_counts()
    got = eps.phased_normalize(y, scale8, shift8)
    torch.cuda.synchronize()
    assert launch_counts["phased_normalize"] == 1
    torch.testing.assert_close(got, eps.phased_normalize_plain(y, scale8, shift8),
                               rtol=0, atol=0)


def _with_ties(x):
    """x (..., 8C) with sub-positions 3 and 6 copying 1 on every other
    channel, and all 8 equal on every fourth."""
    x8 = x.unflatten(-1, (8, x.shape[-1] // 8)).clone()
    x8[..., 3, ::2] = x8[..., 1, ::2]
    x8[..., 6, ::2] = x8[..., 1, ::2]
    x8[..., :, ::4] = x8[..., :1, ::4]
    return x8.flatten(-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c8", [16, 24, 256, 512])
def test_pool_backward_kernel_matches_plain(dev, dtype, c8):
    """Mask and fused forms, ties included, any lane width (24: the
    one-element path): exact."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = _with_ties(torch.randn((2, 4, 5, 6, c8), generator=g, device=dev)).to(dtype)
    ct = torch.randn((2, 4, 5, 6, c8 // 8), generator=g, device=dev).to(dtype)
    for gg in (None, ct):
        reset_launch_counts()
        got = ps2d.max_pool_s2d_bwd(x, gg)
        torch.cuda.synchronize()
        assert launch_counts["max_pool_s2d_bwd"] == 1
        torch.testing.assert_close(got, ps2d.max_pool_s2d_bwd_plain(x, gg), rtol=0, atol=0)


def test_train_grads_on_card_match_cpu(dev):
    """Stage-1 loss and gradients, float32, on the card (kernels) against
    the CPU (plain versions), same weights and DropLayer draws."""
    cfg = SEUNetConfig()
    tree = SEUNet(cfg, generator=torch.Generator().manual_seed(0)).params_tree()
    gen = torch.Generator().manual_seed(1)
    batch = {"image": torch.rand((2, 32, 32, 32, 2), generator=gen),
             "label": (torch.rand((2, 32, 32, 32), generator=gen) > 0.7).float()}
    draws = [torch.rand((2, 24), generator=gen), torch.rand((2, 12), generator=gen)]
    out = {}
    for d in ("cpu", dev):
        leaves = _tree_map(lambda t: t.detach().to(d).requires_grad_(True), tree)
        reset_launch_counts()
        loss, _ = make_loss_fn(cfg, 1)(leaves, {k: v.to(d) for k, v in batch.items()},
                                       drop_draws=draws)
        loss.backward()
        out[str(d)] = (loss.detach().cpu(), dict(launch_counts), [
            torch.zeros(t.shape) if t.grad is None else t.grad.cpu() for t in _leaves(leaves)])
    (l_cpu, n_cpu, g_cpu), (l_gpu, n_gpu, g_gpu) = out["cpu"], out[str(dev)]
    assert not any(n_cpu.values())
    assert n_gpu == _counts(gathered_epilogue=10, phased_epilogue=5, phased_normalize=5,
                            max_pool_s2d_bwd=2, norm_stats=30)
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-5, atol=1e-6)
    # each leaf also within 2e-2 of its own norm (LEAF_RTOL_PORT,
    # tests/test_torch_train.py)
    floor = 1e-6 * max(float(b.norm()) for b in g_cpu)
    for a, b in zip(g_gpu, g_cpu):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-4)
        assert float((a - b).norm()) <= 2e-2 * float(b.norm()) + floor


def _conv_stats_close(got, ref, mag):
    """y within one ulp of the plain version in bf16, plus 2^-18 of the
    sum of the |terms| `mag` (both round an f32 sum once, summed in
    another order: near zero that order moves y by more than an ulp); at
    1e-5 in f32. s1, s2 within 1e-4 of each channel's sum of |y| and of
    y^2."""
    (y, s1, s2), (ry, r1, r2) = got, ref
    assert y.dtype == ry.dtype and s1.dtype == s2.dtype == torch.float32
    if y.dtype == torch.bfloat16:
        r = ry.float()
        ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
        d = (y.float() - r).abs()
        assert bool((d <= ulp + 2.0 ** -18 * mag).all()), float(d.max())
    else:
        torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-5)
    ryf = ry.float()
    for s, rs, m in ((s1, r1, ryf.abs()), (s2, r2, ryf.square())):
        lim = 1e-4 * m.sum(dim=(1, 2, 3)) + 1e-6
        assert bool(((s - rs).abs() <= lim).all()), float((s - rs).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,cis,co", [(2, 8, (64,), 8), (1, 5, (64, 64), 16),
                                        (2, 4, (128,), 64), (3, 5, (64, 192), 32),
                                        (1, 33, (128,), 8), (1, 33, (64,), 16),
                                        (2, 6, (64, 64), 64)])
def test_phased_conv_stats_kernel_matches_plain(dev, dtype, b, n, cis, co):
    """One input and a two-input plain concat, of equal and of unequal
    widths (64 + 192); 8Co of 64, 128, 256 and 512 (two column tiles of
    the bf16 kernel); n = 5 and 33, whose (n+1)^3 grids end in a ragged
    128-row tile; batch 3."""
    g = torch.Generator(device=dev).manual_seed(7)
    xs = [torch.randn((b, n, n, n, c), generator=g, device=dev).to(dtype) for c in cis]
    w_all = (0.05 * torch.randn((8, sum(cis), 8 * co), generator=g, device=dev)).to(dtype)
    b_all = 0.1 * torch.randn((8 * co,), generator=g, device=dev)
    reset_launch_counts()
    got = pcs.phased_conv_stats(xs, w_all, b_all)
    torch.cuda.synchronize()
    assert launch_counts["phased_conv_stats"] == 1
    assert got[0].shape == (b, n, n, n, 8 * co)
    mag = pcs.phased_conv_stats_plain([t.abs() for t in xs], w_all.abs(), 0 * b_all)[0]
    _conv_stats_close(got, pcs.phased_conv_stats_plain(xs, w_all, b_all), mag.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,ci,co", [(2, 8, 16, 32), (1, 5, 8, 8), (3, 4, 32, 64)])
def test_dil2_conv_stats_kernel_matches_plain(dev, dtype, b, n, ci, co):
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((b, n, n, n, 8 * ci), generator=g, device=dev).to(dtype)
    w = (0.1 * torch.randn((3, 3, 3, ci, co), generator=g, device=dev)).to(dtype)
    bias = 0.1 * torch.randn((co,), generator=g, device=dev)
    reset_launch_counts()
    got = pcs.dil2_conv_stats(x, w, bias)
    torch.cuda.synchronize()
    assert launch_counts["dil2_conv_stats"] == 1
    mag = pcs.dil2_conv_stats_plain(x.abs(), w.abs(), 0 * bias)[0]
    _conv_stats_close(got, pcs.dil2_conv_stats_plain(x, w, bias), mag.float())


def test_conv_stats_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    x = torch.randn((1, 4, 4, 4, 64), device=dev)
    w_all = torch.randn((8, 64, 64), device=dev)
    b_all = torch.zeros(64, device=dev)
    with pytest.raises(TypeError):
        pcs.phased_conv_stats(x.half(), w_all.half(), b_all)
    with pytest.raises(ValueError):
        pcs.phased_conv_stats(x, w_all.to(torch.bfloat16), b_all)
    with pytest.raises(ValueError):
        pcs.phased_conv_stats([x, x, x], torch.randn((8, 192, 64), device=dev), b_all)
    bf = torch.bfloat16
    x32 = x[..., :32].contiguous().to(bf)
    with pytest.raises(ValueError):  # bf16: Cin % 64 != 0
        pcs.phased_conv_stats(x32, torch.randn((8, 32, 64), device=dev).to(bf), b_all)
    with pytest.raises(ValueError):  # bf16: a 32 + 32 concat, each input % 64 != 0
        pcs.phased_conv_stats([x32, x32], w_all.to(bf), b_all)
    with pytest.raises(ValueError):  # bf16: 8Co = 192
        pcs.phased_conv_stats(x.to(bf), torch.randn((8, 64, 192), device=dev).to(bf),
                              torch.zeros(192, device=dev))
    with pytest.raises(ValueError):  # Co = 4
        pcs.dil2_conv_stats(x, torch.randn((3, 3, 3, 8, 4), device=dev),
                            torch.zeros(4, device=dev))


def test_apply_fast_conv_stats_on_card_matches_cpu(dev):
    """The conv_stats forward in float32 on the card (kernels) against
    the CPU (plain versions), with its launches: 5 phased and 3 dil-2
    conv stats, 7 gathered epilogues, no phased epilogue."""
    cfg = SEUNetConfig(conv_stats=True)
    model = SEUNet(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, 32, 32, 2), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = se_unet_apply_fast(model.params_tree(), x, cfg=cfg)
        reset_launch_counts()
        got = se_unet_apply_fast(model.to(dev).params_tree(), x.to(dev), cfg=cfg)
    assert launch_counts == _counts(gathered_epilogue=7, phased_conv_stats=5,
                                    dil2_conv_stats=3, norm_stats=7)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-3, atol=1e-4)


def _check_dil2_bf16(dev, b, n, ci, co, seed, zero_weight=False):
    """The bf16 dil-2 kernel (csrc/dil2_wgmma.cu) on one shape against
    its plain version, at the tolerances of `_conv_stats_close`; returns
    the outputs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, n, n, n, 8 * ci), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((3, 3, 3, ci, co), generator=g, device=dev) / (27 * ci) ** 0.5
    w = (0 * w if zero_weight else w).to(torch.bfloat16)
    bias = 0.1 * torch.randn((co,), generator=g, device=dev)
    reset_launch_counts()
    got = pcs.dil2_conv_stats(x, w, bias)
    torch.cuda.synchronize()
    assert launch_counts == _counts(dil2_conv_stats=1)
    assert got[0].shape == (b, n, n, n, 8 * co)
    mag = pcs.dil2_conv_stats_plain(x.abs(), w.abs(), 0 * bias)[0]
    _conv_stats_close(got, pcs.dil2_conv_stats_plain(x, w, bias), mag.float())
    return got, bias


@pytest.mark.parametrize("b,n,ci,co", [(1, 5, 8, 8), (2, 6, 8, 24), (1, 7, 16, 32),
                                       (3, 6, 32, 64), (2, 4, 64, 64), (1, 4, 112, 16),
                                       (1, 9, 24, 48), (1, 9, 16, 48)])
def test_dil2_conv_stats_bf16_brick_edges(dev, b, n, ci, co):
    """Ragged n (4, 5, 6, 7, 9: a brick edge in every axis, bricks of 8 x
    ty x tz), Ci = 8 and 24 (k16 steps that span two taps, and one past
    the 27 taps), batch 2 and 3, widths whose tile takes smaller bricks
    (Ci 64, 112) and column tiles of 8, 16 and 32 (Co 24, 48, 64 at Ci 64)."""
    assert pcs.dil2_tile(ci, co)[3] <= 232448
    _check_dil2_bf16(dev, b, n, ci, co, seed=n + ci + co)


@pytest.mark.parametrize("n,ci,co", [(64, 16, 32), (32, 32, 32), (32, 32, 64)])
def test_dil2_conv_stats_bf16_model_shapes(dev, n, ci, co):
    """ec3, ec5 and ec6 at batch 1."""
    _check_dil2_bf16(dev, 1, n, ci, co, seed=ci + co)


def test_dil2_conv_stats_bf16_zero_weight(dev):
    """An all-zero weight: y is the bias, and each lane's sums are n^3
    times the bias and its square."""
    b, n, ci, co = 2, 6, 16, 32
    (y, s1, s2), bias = _check_dil2_bf16(dev, b, n, ci, co, seed=3, zero_weight=True)
    b8 = bias.repeat(8)
    torch.testing.assert_close(y, b8.to(torch.bfloat16).expand_as(y), rtol=0, atol=0)
    torch.testing.assert_close(s1, n ** 3 * b8.expand(b, 8 * co), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2, n ** 3 * b8.square().expand(b, 8 * co), rtol=1e-5,
                               atol=1e-6)


def test_dil2_tile_shared_memory_matches_the_kernel(dev):
    """The wrapper's shape-only tile chooser counts the shared memory the
    kernel asks for, and the bf16 wrapper refuses widths no tile fits."""
    lib = build_kernels().lib
    for ci, co in [(8, 8), (16, 32), (32, 32), (32, 64), (64, 64), (112, 16), (24, 48)]:
        ty, tz, bn, smem = pcs.dil2_tile(ci, co)
        assert lib.airseg_dil2_wgmma_smem(ci, ty, tz, bn) == smem <= 232448
    x = torch.zeros((1, 4, 4, 4, 8 * 120), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        pcs.dil2_conv_stats(x, torch.zeros((3, 3, 3, 120, 8), device=dev,
                                           dtype=torch.bfloat16), torch.zeros(8, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c8,c8o", [(2, 8, 128, 128), (1, 5, 64, 64), (3, 4, 32, 192)])
def test_dil2_dense_conv_stats_kernel_matches_plain(dev, dtype, b, n, c8, c8o):
    """Any dense kernel; n = 5 is no multiple of the 128-voxel tile."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((b, n, n, n, c8), generator=g, device=dev).to(dtype)
    wd = (0.05 * torch.randn((3, 3, 3, c8, c8o), generator=g, device=dev)).to(dtype)
    bg = 0.1 * torch.randn((c8o,), generator=g, device=dev)
    reset_launch_counts()
    (y, s1, s2) = pcs.dil2_dense_conv_stats(x, wd, bg)
    torch.cuda.synchronize()
    assert launch_counts == _counts(dil2_dense_conv_stats=1)
    ry, r1, r2 = pcs.dil2_dense_conv_stats_plain(x, wd, bg)
    mag = pcs.dil2_dense_conv_stats_plain(x.abs(), wd.abs(), 0 * bg)[0]
    _ulp_close(y, ry, mag.float())
    ryf = ry.float()
    for s, rs, m in ((s1, r1, ryf.abs()), (s2, r2, ryf.square())):
        assert s.dtype == torch.float32
        lim = 1e-4 * m.sum(dim=(1, 2, 3)) + 1e-6
        assert bool(((s - rs).abs() <= lim).all()), float((s - rs).abs().max())


def _ulp_close(y, ry, mag):
    """y within one bf16 ulp (1e-5 relative in f32) of the plain version,
    plus 2^-18 of the sum of the |terms| `mag`: both round an f32 sum of
    up to 27 x 256 products once, summed in another order (see
    `_conv_stats_close`)."""
    assert y.dtype == ry.dtype and y.shape == ry.shape
    r = ry.float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8) \
        if y.dtype == torch.bfloat16 else 1e-5 * r.abs()
    d = (y.float() - r).abs()
    assert bool((d <= ulp + 2.0 ** -18 * mag).all()), float(d.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,cis,c8o,bias", [(2, 8, (64,), 128, True),
                                              (1, 5, (64, 64), 128, True),
                                              (2, 4, (128,), 512, False),
                                              (3, 6, (32, 96), 64, False)])
def test_phased_conv_ungathered_kernel_matches_plain(dev, dtype, b, n, cis, c8o, bias):
    """One and two inputs, with and without bias; (n+1)^3 = 216 and 125
    are no multiple of the 128-voxel tile."""
    g = torch.Generator(device=dev).manual_seed(10)
    xs = [torch.randn((b, n, n, n, c), generator=g, device=dev).to(dtype) for c in cis]
    w_all = (0.05 * torch.randn((2, 2, 2, sum(cis), c8o), generator=g, device=dev)).to(dtype)
    b_all = 0.1 * torch.randn((c8o,), generator=g, device=dev) if bias else None
    reset_launch_counts()
    got = pcs.phased_conv_ungathered(xs, w_all, b_all)
    torch.cuda.synchronize()
    assert launch_counts == _counts(phased_conv_ungathered=1)
    assert got.shape == (b, n + 1, n + 1, n + 1, c8o)
    mag = pcs.phased_conv_ungathered_plain([t.abs() for t in xs], w_all.abs())
    _ulp_close(got, pcs.phased_conv_ungathered_plain(xs, w_all, b_all), mag.float())


def _dense_case(dev, b, n, c8, c8o, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, n, n, n, c8), generator=g, device=dev).to(torch.bfloat16)
    bg = 0.1 * torch.randn((c8o,), generator=g, device=dev)
    return g, x, bg


def _check_dense(x, wd, bg):
    """One bf16 dense launch against the plain version, at the
    tolerances of test_dil2_dense_conv_stats_kernel_matches_plain; returns
    the k-step tiles the launch executed and the tiles of the dense GEMM."""
    reset_launch_counts()
    got = pcs.dil2_dense_conv_stats(x, wd, bg)
    torch.cuda.synchronize()
    assert launch_counts == _counts(dil2_dense_conv_stats=1)
    mag = pcs.dil2_dense_conv_stats_plain(x.abs(), wd.abs(), 0 * bg)[0]
    _conv_stats_close(got, pcs.dil2_dense_conv_stats_plain(x, wd, bg), mag.float())
    plan = pcs.dense_tiles
    return int(plan["count"].sum()), plan["count"].numel() * plan["nsteps"]


@pytest.mark.parametrize("c8,c8o,bn,frac", [(256, 256, 64, 1 / 4), (128, 256, 128, 1 / 2),
                                            (64, 256, 256, 1.0)])
def test_dil2_dense_conv_stats_block_diagonal_skips_zero_tiles(dev, c8, c8o, bn, frac):
    """bf16 on the block-diagonal lift the model passes, at each column
    tile: ec5's widths (BN 64, a quarter of the k-steps), ec3's (BN 128,
    half) and Ci = 8 (BN 256, every k-step holds a nonzero). The launch
    executes the fraction of tiles the table predicts."""
    g, x, _ = _dense_case(dev, 2, 5, c8, c8o, 11)
    w = (0.1 * torch.randn((3, 3, 3, c8 // 8, c8o // 8), generator=g, device=dev))
    wd = ps2d.dil2_dense_weight(w, torch.bfloat16)
    bg = (0.1 * torch.randn((c8o // 8,), generator=g, device=dev)).repeat(8)
    assert pcs.dense_bn(c8, c8o) == bn
    executed, tiles = _check_dense(x, wd, bg)
    assert executed == frac * tiles and pcs.dense_tiles["bn"] == bn


def test_dil2_dense_conv_stats_tile_sparse_and_zero_weight(dev):
    """bf16 on a dense weight with random whole (BN x 64) k-step tiles
    zeroed: the launch executes exactly the nonzero tiles; on an all-zero
    weight it executes none, and y is the bias, with its sums."""
    b, n, c8, c8o = 2, 6, 128, 256
    g, x, bg = _dense_case(dev, b, n, c8, c8o, 12)
    bn = pcs.dense_bn(c8, c8o)
    keep = torch.rand((c8o // bn, 27, c8 // 64), generator=g, device=dev) < 0.3
    mask = keep[:, None, :, :, None].expand(c8o // bn, bn, 27, c8 // 64, 64)
    mask = mask.reshape(c8o, 3, 3, 3, c8).permute(1, 2, 3, 4, 0)
    wd = ((0.05 * torch.randn((3, 3, 3, c8, c8o), generator=g, device=dev)) * mask)
    wd = wd.to(torch.bfloat16)
    assert _check_dense(x, wd, bg) == (int(keep.sum()), keep.numel())
    zero = torch.zeros_like(wd)
    assert _check_dense(x, zero, bg) == (0, keep.numel())
    y, s1, s2 = pcs.dil2_dense_conv_stats(x, zero, bg)
    torch.testing.assert_close(y, bg.to(torch.bfloat16).expand_as(y), rtol=0, atol=0)
    torch.testing.assert_close(s1, n ** 3 * bg.expand(b, c8o), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,n,cis,c8o,bias", [(2, 6, (128,), 256, True),
                                              (2, 6, (128,), 256, False),
                                              (1, 9, (64, 64), 192, True),
                                              (1, 9, (64, 64), 192, False)])
def test_phased_conv_ungathered_bf16_ragged_grid(dev, b, n, cis, c8o, bias):
    """bf16 with (n+1)^3 = 343 and 1000, no multiple of the 128-row tile,
    with and without bias; 8Co = 192 runs three 64-column tiles."""
    g = torch.Generator(device=dev).manual_seed(13)
    xs = [torch.randn((b, n, n, n, c), generator=g, device=dev).to(torch.bfloat16)
          for c in cis]
    w_all = 0.05 * torch.randn((2, 2, 2, sum(cis), c8o), generator=g, device=dev)
    w_all = w_all.to(torch.bfloat16)
    b_all = 0.1 * torch.randn((c8o,), generator=g, device=dev) if bias else None
    reset_launch_counts()
    got = pcs.phased_conv_ungathered(xs, w_all, b_all)
    torch.cuda.synchronize()
    assert launch_counts == _counts(phased_conv_ungathered=1)
    mag = pcs.phased_conv_ungathered_plain([t.abs() for t in xs], w_all.abs())
    _ulp_close(got, pcs.phased_conv_ungathered_plain(xs, w_all, b_all), mag.float())


def test_conv_epi_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.randn((1, 4, 4, 4, 64), device=dev)
    with pytest.raises(ValueError):  # C8o = 32
        pcs.dil2_dense_conv_stats(x, torch.randn((3, 3, 3, 64, 32), device=dev),
                                  torch.zeros(32, device=dev))
    with pytest.raises(ValueError):  # three inputs
        pcs.phased_conv_ungathered([x, x, x], torch.randn((2, 2, 2, 192, 64), device=dev))
    with pytest.raises(TypeError):
        pcs.phased_conv_ungathered(x.half(), torch.randn((2, 2, 2, 64, 64), device=dev).half())
    with pytest.raises(TypeError):
        norm_leaky.instance_norm_leaky(torch.randn((1, 8, 4), device=dev).half())


def test_apply_fast_conv_epi_on_card_matches_cpu(dev):
    """The conv_epi forward in float32 on the card (kernels) against the
    CPU (plain versions), with its launches: 3 dense dil-2 conv stats, 5
    ungathered phased convs, 10 gathered and 5 phased epilogues."""
    cfg = SEUNetConfig(conv_epi=True)
    model = SEUNet(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, 32, 32, 2), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        ref = se_unet_apply_fast(model.params_tree(), x, cfg=cfg)
        reset_launch_counts()
        got = se_unet_apply_fast(model.to(dev).params_tree(), x.to(dev), cfg=cfg)
    assert launch_counts == _counts(gathered_epilogue=10, phased_epilogue=5,
                                    dil2_dense_conv_stats=3, phased_conv_ungathered=5,
                                    norm_stats=12)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,c", [(1, 4096, 256), (8, 8192, 32), (2, 1000, 40), (1, 7, 3)])
def test_instance_norm_leaky_kernels_match_plain(dev, dtype, b, s, c):
    """Forward and backward against their plain versions; c = 40 and 3
    leave a channel tile partly empty. bf16: one ulp where the reordered
    f32 statistics move the rounding."""
    g = torch.Generator(device=dev).manual_seed(11)
    x = (1.5 * torch.randn((b, s, c), generator=g, device=dev) + 0.3).to(dtype)
    ct = torch.randn((b, s, c), generator=g, device=dev).to(dtype)
    reset_launch_counts()
    y, rstd = norm_leaky._norm_leaky_fwd(x)
    dx = norm_leaky._norm_leaky_bwd(ct, y, rstd)
    torch.cuda.synchronize()
    assert launch_counts == _counts(instance_norm_leaky_fwd=1, instance_norm_leaky_bwd=1)
    ry, rr = norm_leaky.instance_norm_leaky_plain(x)
    torch.testing.assert_close(rstd, rr, rtol=1e-5, atol=0)
    rdx = norm_leaky.instance_norm_leaky_bwd_plain(ct, y, rstd)
    for got, ref in ((y, ry), (dx, rdx)):
        if dtype == torch.bfloat16:
            r = ref.float()
            ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
            assert bool(((got.float() - r).abs() <= ulp + 1e-6).all())
        else:
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def _zy_swapped(y):
    """y's values in a layout whose z stride is below its y stride: no TMA
    map describes it, so the phased forms take 16-byte loads."""
    return y.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c8,gates,xw", [(1, 65, 128, 1, None), (3, 33, 256, 2, 40),
                                             (1, 9, 512, 2, None), (3, 5, 64, 0, 9),
                                             (1, 33, 512, 1, None), (2, 17, 64, 1, None),
                                             (2, 9, 128, 2, 12)])
def test_persistent_epilogue_designs_match_plain(dev, swap, dtype, b, n, c8, gates, xw):
    """Each design, reached by shape and strides, at ragged tiles (no T
    divides n), xw > n+1 and 0/1/2 gates: phased epilogue and normalize
    (exact) on y_ext as made (TMA where its box rows hold 128 bytes) and
    with z and y strides swapped (16-byte loads), and the gathered form,
    whose one design serves every width (8C = 64 and 128 included)."""
    y, scale8, shift8, wse = _inputs(dev, dtype, b, n + 1, c8, gates, xw=xw, seed=n)
    if swap:
        y = _zy_swapped(y)
        assert eps.pick_design(y, True) == "persistent ldg"
    got = eps.phased_epilogue(y, scale8, shift8, wse)
    torch.testing.assert_close(got, eps.phased_epilogue_plain(y, scale8, shift8, wse),
                               **TOL[dtype])
    got = eps.phased_normalize(y, scale8, shift8)
    torch.testing.assert_close(got, eps.phased_normalize_plain(y, scale8, shift8),
                               rtol=0, atol=0)
    yg = y[:, :n, :n, :n].contiguous()
    got = eps.gathered_epilogue(yg, scale8, shift8, wse)
    torch.testing.assert_close(got, eps.gathered_epilogue_plain(yg, scale8, shift8, wse),
                               **TOL[dtype])


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nz,n,c8,gates,xw", [(8, 32, 64, 256, 1, None),
                                                (8, 16, 32, 512, 2, None),
                                                (2, 3, 33, 256, 2, 40), (1, 1, 9, 128, 1, None),
                                                (3, 2, 5, 64, 0, 9)])
def test_epilogue_designs_on_depth_slabs_match_plain(dev, swap, dtype, b, nz, n, c8, gates,
                                                     xw):
    """K1, K2 and K5 on a depth slab of the mesh's `space` axis, each
    design by shape and strides (`swap`: 16-byte loads, as in
    test_persistent_epilogue_designs_match_plain): the phased forms read
    y_ext (B, nz+1, n+1, xw, 8C) (the window grid of a halo'd phased
    conv), the gathered form (B, nz, n, n, 8C); at the model's slab shapes
    of 128^3 crops on 2 ranks (dc5 at the full grid, dc3 at the 1/2 grid)
    and ragged ones."""
    g = torch.Generator(device=dev).manual_seed(nz * n)
    y = torch.randn((b, nz + 1, n + 1, xw or n + 1, c8), generator=g, device=dev).to(dtype)
    scale8 = 0.5 + torch.rand((b, c8), generator=g, device=dev)
    shift8 = 0.3 * torch.randn((b, c8), generator=g, device=dev)
    wse = (0.1 * torch.randn((gates, c8 // 8), generator=g, device=dev)).to(dtype) \
        if gates else None
    if swap:
        y = _zy_swapped(y)
        assert eps.pick_design(y, True) == "persistent ldg"
    reset_launch_counts()
    got = eps.phased_epilogue(y, scale8, shift8, wse)
    assert got.shape == (b, nz, n, n, c8)
    torch.testing.assert_close(got, eps.phased_epilogue_plain(y, scale8, shift8, wse),
                               **TOL[dtype])
    got = eps.phased_normalize(y, scale8, shift8)
    torch.testing.assert_close(got, eps.phased_normalize_plain(y, scale8, shift8),
                               rtol=0, atol=0)
    yg = y[:, :nz, :n, :n].contiguous()
    got = eps.gathered_epilogue(yg, scale8, shift8, wse)
    torch.cuda.synchronize()
    assert launch_counts == _counts(gathered_epilogue=1, phased_epilogue=1, phased_normalize=1)
    torch.testing.assert_close(got, eps.gathered_epilogue_plain(yg, scale8, shift8, wse),
                               **TOL[dtype])


def test_phased_epilogue_takes_ldg_where_tma_cannot(dev):
    """A y_ext whose z stride is below its y stride cannot be a TMA map:
    the wrapper picks the 16-byte-load design by shape, before the launch."""
    y, scale8, shift8, wse = _inputs(dev, torch.bfloat16, 2, 10, 256, 2, xw=12, seed=3)
    swapped = y.transpose(1, 2)
    assert eps.pick_design(swapped, True) == "persistent ldg"
    assert eps.pick_design(y, True) == "persistent tma"  # bf16, 2C = 64 lanes: 128-byte rows
    reset_launch_counts()
    got = eps.phased_epilogue(swapped, scale8, shift8, wse)
    torch.cuda.synchronize()
    assert launch_counts["phased_epilogue"] == 1
    torch.testing.assert_close(got, eps.phased_epilogue_plain(swapped, scale8, shift8, wse),
                               **TOL[torch.bfloat16])


def _bwd_check(dtype, got, ref):
    if dtype == torch.bfloat16:
        r = ref.float()
        ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
        assert bool(((got.float() - r).abs() <= ulp + 1e-6).all())
    else:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,c", [(1, 7, 3), (2, 1000, 40), (1, 64 ** 3, 256),
                                   (8, 64 ** 3 * 8, 32), (1, 300, 4096)])
def test_instance_norm_leaky_bwd_at_the_smoke_shapes(dev, dtype, b, s, c):
    """The backward against its plain version: the bulk-copy ring at the
    smoke shapes and C = 40, register loads of 16-byte vectors at C = 4096
    (wider than a block row), one channel per thread at C = 3."""
    g = torch.Generator(device=dev).manual_seed(c)
    x = (1.5 * torch.randn((b, s, c), generator=g, device=dev) + 0.3).to(dtype)
    ct = torch.randn((b, s, c), generator=g, device=dev).to(dtype)
    y, rstd = norm_leaky.instance_norm_leaky_plain(x)
    dx = norm_leaky._norm_leaky_bwd(ct, y, rstd)
    _bwd_check(dtype, dx, norm_leaky.instance_norm_leaky_bwd_plain(ct, y, rstd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_leaky_bwd_misaligned_view(dev, dtype):
    """A base 2 (bf16) or 4 (f32) bytes past a 16-byte boundary: the
    scalar path, chosen by the pointers before the launch."""
    b, s, c = 2, 999, 64
    g = torch.Generator(device=dev).manual_seed(5)
    x = (torch.randn((b, s, c), generator=g, device=dev) + 0.2).to(dtype)
    buf = torch.randn((b * s * c + 1,), generator=g, device=dev).to(dtype)
    ct = buf[1:].view(b, s, c)
    assert ct.data_ptr() % 16 and ct.is_contiguous()
    y, rstd = norm_leaky.instance_norm_leaky_plain(x)
    dx = norm_leaky._norm_leaky_bwd(ct, y, rstd)
    _bwd_check(dtype, dx, norm_leaky.instance_norm_leaky_bwd_plain(ct, y, rstd))


def test_tma_epilogue_rings_of_several_sizes_in_turn(dev):
    """One kernel instance at three ring sizes, large, small, large: every
    size asked before stays launchable (the launcher caches the kernel's
    occupancy per size and never lowers its shared memory limit)."""
    for n, c8 in ((6, 512), (6, 256), (7, 512)):
        y, scale8, shift8, wse = _inputs(dev, torch.bfloat16, 2, n + 1, c8, 1, seed=c8)
        assert eps.pick_design(y, True) == "persistent tma"
        got = eps.phased_epilogue(y, scale8, shift8, wse)
        torch.testing.assert_close(got, eps.phased_epilogue_plain(y, scale8, shift8, wse),
                                   **TOL[torch.bfloat16])


def _fwd_check(dtype, y, rstd, x):
    ry, rr = norm_leaky.instance_norm_leaky_plain(x)
    torch.testing.assert_close(rstd, rr, rtol=1e-5, atol=0)
    _bwd_check(dtype, y, ry)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,c", [(1, 7, 3), (2, 1000, 40), (1, 64 ** 3, 256),
                                   (8, 64 ** 3 * 8, 32), (1, 300, 4096), (3, 5, 8)])
def test_instance_norm_leaky_fwd_at_the_smoke_shapes(dev, dtype, b, s, c):
    """The forward against its plain version, one launch per wrapper call:
    the bulk-copy ring at the smoke shapes, C = 40 and 8 (fewer rows than a
    block row holds), register loads of 16-byte vectors at C = 4096 (wider
    than a block row), one channel per thread at C = 3. y within one bf16
    ulp, rstd at rtol 1e-5."""
    g = torch.Generator(device=dev).manual_seed(c)
    x = (1.5 * torch.randn((b, s, c), generator=g, device=dev) + 0.3).to(dtype)
    reset_launch_counts()
    y, rstd = norm_leaky._norm_leaky_fwd(x)
    torch.cuda.synchronize()
    assert launch_counts == _counts(instance_norm_leaky_fwd=1)
    _fwd_check(dtype, y, rstd, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_leaky_fwd_misaligned_view(dev, dtype):
    """x based one element past a 16-byte boundary: the scalar path,
    chosen by the pointers before the launch."""
    b, s, c = 2, 999, 64
    g = torch.Generator(device=dev).manual_seed(6)
    buf = (torch.randn((b * s * c + 1,), generator=g, device=dev) + 0.2).to(dtype)
    x = buf[1:].view(b, s, c)
    assert x.data_ptr() % 16 and x.is_contiguous()
    y, rstd = norm_leaky._norm_leaky_fwd(x)
    _fwd_check(dtype, y, rstd, x)


def test_instance_norm_leaky_ring_smem_matches_the_rule(dev):
    """The ring's shared memory, both directions: the stages' barriers and
    RING_SLOTS stages of RING_BYTES (6 of x, or 3 of g and y)."""
    lib = build_kernels().lib
    assert lib.airseg_norm_leaky_ring_smem() == 128 + norm_leaky.RING_SLOTS * norm_leaky.RING_BYTES
    assert [norm_leaky.ring_stages(bwd) for bwd in (False, True)] == [6, 3]


# K12 (norm_stats): f32 sums in another order than the plain version's
# (per thread over its rows, then over a block's threads, then over the
# blocks). Each is held to the float64 sums within NS_RTOL of the lane's
# sum of |y| (s1) or of its sum of squares (s2): a thread adds up to ~500
# rows in turn (worst case 500 * 2^-24 = 3e-5; rounding errors at random
# ~sqrt(500) * 2^-24 = 1.3e-6), the plain version's cascade less.
NS_RTOL = 1e-5
# (block, form, s2d grid n, 8C) of every statistics call of a tile batch of
# 128^3 tiles at batch 8: the 10 gathered blocks and the 5 phased ones
NS_CALLS = [("ec1", False, 64, 64), ("ec2", False, 64, 128), ("ec3", False, 64, 256),
            ("ec33", False, 64, 256), ("x33", False, 64, 256), ("ec5", False, 32, 256),
            ("ec6", False, 32, 512), ("ec63", False, 32, 512), ("x63", False, 32, 512),
            ("dc42", False, 32, 256), ("ec4", True, 32, 256), ("dc3", True, 32, 512),
            ("dc4", True, 32, 256), ("dc5", True, 64, 256), ("dc6", True, 64, 128)]


def _ns_check(got, y, phased):
    """The (2, B, 8C) sums against the float64 sums of y, within NS_RTOL."""
    exact = eps.norm_stats_plain(y.double(), phased)
    mag = torch.stack([eps.norm_stats_plain(y.double().abs(), phased)[0], exact[1]])
    assert got.shape == exact.shape and got.dtype == torch.float32
    err = ((got.double() - exact).abs() / (NS_RTOL * mag + 1e-30)).max()
    assert float(err) <= 1.0, float(err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block,phased,n,c8", NS_CALLS, ids=[c[0] for c in NS_CALLS])
def test_norm_stats_kernel_at_the_model_shapes(dev, dtype, block, phased, n, c8):
    """K12 at every statistics call of the main path (batch 8, 128^3
    tiles), both dtypes: against its plain version and the float64 sums,
    one launch counted, two launches bitwise equal."""
    g = torch.Generator(device=dev).manual_seed(n + c8)
    m = n + 1 if phased else n
    y = torch.randn((8, m, m, m, c8), generator=g, device=dev).to(dtype)
    reset_launch_counts()
    got = eps.norm_stats(y, phased)
    again = eps.norm_stats(y, phased)
    torch.cuda.synchronize()
    assert launch_counts == _counts(norm_stats=2)
    assert torch.equal(got, again)
    _ns_check(got, y, phased)
    _ns_check(eps.norm_stats_plain(y, phased), y, phased)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nz,n,c8,xw", [(8, 32, 64, 256, None), (8, 16, 32, 512, None),
                                          (3, 2, 5, 64, 9), (1, 1, 9, 128, None),
                                          (2, 3, 33, 256, 40), (1, 4, 4, 64, None)])
def test_norm_stats_kernel_on_slabs_and_ragged_shapes(dev, dtype, b, nz, n, c8, xw):
    """Both forms on depth slabs of the mesh's `space` axis (the model's
    slabs of 128^3 crops on 2 ranks, dc5 and dc3) and on ragged grids: the
    phased form on y_ext (B, nz+1, n+1, xw, 8C), xw > n+1 read through the
    strides, the gathered form on (B, nz, n, n, 8C); the row walk wraps
    where its step exceeds n."""
    g = torch.Generator(device=dev).manual_seed(nz * n + c8)
    y = torch.randn((b, nz + 1, n + 1, xw or n + 1, c8), generator=g, device=dev).to(dtype)
    _ns_check(eps.norm_stats(y, phased=True), y, True)
    yg = y[:, :nz, :n, :n].contiguous()
    _ns_check(eps.norm_stats(yg), yg, False)


def test_norm_stats_refuses_what_the_kernel_does_not_take(dev):
    """float64, a non-contiguous y, a width whose vectors do not split a
    lane block, a gathered y that is not (B, nz, n, n, 8C): raises, never a
    plain fallback."""
    y = torch.randn((2, 5, 5, 5, 64), device=dev)
    reset_launch_counts()
    with pytest.raises(TypeError):
        eps.norm_stats(y.double())
    with pytest.raises(TypeError):
        eps.norm_stats(y.double(), phased=True)
    with pytest.raises(ValueError):
        eps.norm_stats(y.transpose(1, 2))
    with pytest.raises(ValueError):
        eps.norm_stats(y[..., :32], phased=True)
    with pytest.raises(ValueError):
        eps.norm_stats(y.to(torch.bfloat16)[..., :32].contiguous(), phased=True)  # C = 4 lanes
    with pytest.raises(ValueError):
        eps.norm_stats(y[:, :, :4].contiguous())
    assert launch_counts == _counts()


# the benchmark's lung-box stream (portbench/traffic/lungbox_stream.json)
LUNGBOX_SHAPES = [(416, 320, 416), (256, 224, 288), (352, 288, 352), (320, 256, 320),
                  (384, 256, 384), (288, 224, 320), (352, 320, 384), (320, 288, 352)]


@pytest.mark.parametrize("shape", LUNGBOX_SHAPES)
def test_overlap_count_on_card_equals_the_tile_loop(dev, shape):
    """The runner's reciprocal overlap count built on the card (cube 128,
    step 64, batch 8) against 1 / max(count, 1) of the per-tile host loop,
    bit for bit: the card's float32 reciprocal rounds as numpy's divide.
    Counts only; no model runs."""
    cube = 128
    pos = pad_positions_to_batch(tile_positions(shape, cube, 64), 8)
    cnt = np.zeros(shape, np.float32)
    for x, y, z in pos:
        cnt[x : x + cube, y : y + cube, z : z + cube] += 1.0
    want = 1.0 / np.maximum(cnt, 1.0)
    got = inv_overlap_count(shape, pos, cube, dev)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), want.view(np.uint32))
