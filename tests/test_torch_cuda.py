"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and nvcc and is marked `cuda`; on a
CPU-only host each skips. This file imports no JAX, so it also runs on
the GPU host, which has none:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest`: tests/conftest.py sets up JAX, which that host lacks.)
"""

import pytest
import torch

from se_unet_airseg_tpu_torch.models import SEUNet, SEUNetConfig, se_unet_apply_fast
from se_unet_airseg_tpu_torch.models.se_unet import _leaves, _tree_map
from se_unet_airseg_tpu_torch.ops import epilogue_s2d as eps
from se_unet_airseg_tpu_torch.ops import launch_counts, reset_launch_counts
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
    assert launch_counts == {"gathered_epilogue": 10, "phased_epilogue": 5,
                             "phased_normalize": 0, "max_pool_s2d_bwd": 0}
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
    assert n_gpu == {"gathered_epilogue": 10, "phased_epilogue": 5, "phased_normalize": 5,
                     "max_pool_s2d_bwd": 2}
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-5, atol=1e-6)
    # each leaf also within 2e-2 of its own norm (LEAF_RTOL_PORT,
    # tests/test_torch_train.py)
    floor = 1e-6 * max(float(b.norm()) for b in g_cpu)
    for a, b in zip(g_gpu, g_cpu):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-4)
        assert float((a - b).norm()) <= 2e-2 * float(b.norm()) + floor
