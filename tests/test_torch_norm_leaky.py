"""The port's fused InstanceNorm + LeakyReLU (ops/norm_leaky.py) against
the JAX package's Pallas kernel `instance_norm_leaky`
(ops/pallas_norm.py), which runs in interpret mode on the CPU.

Forward and gradient, float32 at rtol 1e-5, atol 1e-5 (the two sum the
statistics in another order); bfloat16 through the NDHWC and s2d wrappers
within one bf16 ulp, where a reordered f32 sum can move the rounding; and
a pin of the JAX kernel's rounding points: the variance is not clamped at
0, and the slope is the float32 0.01. The kernels themselves run only on
the card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_unet_airseg_tpu.ops import pallas_norm as jpn
from se_unet_airseg_tpu_torch.ops import launch_counts, norm_leaky, reset_launch_counts


def _mk(shape, seed, scale=1.0, shift=0.0):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape) * scale + shift).astype(np.float32)


def _jax_fwd_grad(fn, x, ct):
    """JAX forward and the gradient of sum(f32(fn(x)) * ct)."""
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(ct).astype(y.dtype))
    return np.asarray(y.astype(jnp.float32)), np.asarray(dx.astype(jnp.float32))


def _port_fwd_grad(fn, x, ct, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    y = fn(xt)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    return y.detach().float().numpy(), xt.grad.float().numpy()


@pytest.mark.parametrize("shape", [(2, 512, 16), (1, 300, 40)])
def test_forward_and_grad_match_jax(shape):
    x = _mk(shape, 1, 2.0, 0.5)
    ct = _mk(shape, 2)
    ref = _jax_fwd_grad(jpn.instance_norm_leaky, x, ct)
    reset_launch_counts()
    got = _port_fwd_grad(norm_leaky.instance_norm_leaky, x, ct, torch.float32)
    assert not any(launch_counts.values())  # the CPU takes the plain versions
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


def _within_bf16_ulp(got, ref):
    """|got - ref| within one bf16 ulp of ref (8 significant bits), plus a
    floor for values that round to near zero after cancellation."""
    ulp = np.ldexp(1.0, np.frexp(ref)[1] - 8)
    return np.abs(got - ref) <= ulp + 1e-6


@pytest.mark.parametrize("wrapper,shape", [("ndhwc", (2, 4, 6, 8, 16)),
                                           ("s2d", (2, 4, 4, 4, 64))])
def test_bf16_wrappers_match_jax(wrapper, shape):
    """bf16 in, bf16 out: y and dx within one bf16 ulp; the s2d wrapper
    takes statistics per original channel."""
    x = _mk(shape, 3, 1.5, -0.2)
    ct = _mk(shape, 4)
    name = f"instance_norm_leaky_{wrapper}"
    ref = _jax_fwd_grad(lambda v: getattr(jpn, name)(v.astype(jnp.bfloat16)), x, ct)
    got = _port_fwd_grad(getattr(norm_leaky, name), x, ct, torch.bfloat16)
    for g, r in zip(got, ref):
        assert _within_bf16_ulp(g, r).all(), float(np.abs(g - r).max())


def _two_row_channels(n_ch):
    """(1, 2, C) f32 input whose f32 variance E[x^2] - mean^2 comes out
    negative, but above -1e-5, on some channels: two values between 2 and
    4 that differ by 1e-4 to 2e-4 (a true variance of at most 1e-8, below
    the rounding of E[x^2])."""
    r = np.random.default_rng(5)
    a = (2 + 2 * r.random(n_ch)).astype(np.float32)
    b = (a + np.float32(1e-4) * (1 + r.random(n_ch))).astype(np.float32)
    return np.stack([a, b])[None]


def test_variance_unclamped_and_slope_f32():
    """The kernel's rounding points: var = E[x^2] - mean^2 is not clamped
    at 0, so on the channels where it rounds negative both the JAX kernel
    and the port normalize by rstd = rsqrt(var + eps) > rsqrt(eps) (there
    any reordering of the f32 arithmetic moves rstd a lot, so the port is
    held against the formula, op for op); and the LeakyReLU slope is the
    f32 0.01, not 0.01 rounded to bf16: the bf16 slope misses the JAX
    kernel where the port meets it."""
    x = _two_row_channels(256)
    s1, s2 = x.sum(1), (x * x).sum(1)
    mean = s1 / np.float32(2)
    var = s2 / np.float32(2) - mean * mean
    assert (var < 0).any() and (var > -1e-5).all()
    y, rstd = norm_leaky.instance_norm_leaky_plain(torch.from_numpy(x))
    want_rstd = np.float32(1) / np.sqrt(var + np.float32(1e-5))
    want = (x - mean[:, None]) * want_rstd[:, None]
    want = np.where(want >= 0, want, want * np.float32(0.01))
    np.testing.assert_allclose(rstd.numpy(), want_rstd, rtol=1e-6, atol=0)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=0)
    floor = 1.001 / np.sqrt(np.float32(1e-5))  # rstd of a clamped variance
    jax_rstd = np.asarray(jpn._forward(jnp.asarray(x))[2])
    assert (rstd.numpy() > floor).any() and (jax_rstd > floor).any()

    # slope: bf16 in and out; the bf16-rounded slope moves about a quarter
    # of the negative outputs by one ulp, the reordered statistics almost
    # none
    xb = _mk((2, 2048, 8), 6)
    refb = np.asarray(jpn.instance_norm_leaky(jnp.asarray(xb, jnp.bfloat16)).astype(jnp.float32))
    xt = torch.from_numpy(xb).to(torch.bfloat16)
    gotb = norm_leaky.instance_norm_leaky_plain(xt)[0].float().numpy()
    slope16 = float(torch.tensor(0.01, dtype=torch.bfloat16))
    yf = norm_leaky.instance_norm_leaky_plain(xt.float())[0]
    alt = torch.where(yf >= 0, yf, yf * slope16).to(torch.bfloat16).float().numpy()
    negb = refb < 0
    assert (gotb != refb)[negb].mean() < 0.01
    assert (alt != refb)[negb].mean() > 0.1


def test_backward_reads_the_rounded_y():
    """The backward takes xhat from the saved bf16 y and rstd: the plain
    backward on them equals the autograd gradient."""
    x = torch.from_numpy(_mk((1, 256, 8), 7)).to(torch.bfloat16).requires_grad_(True)
    g = torch.from_numpy(_mk((1, 256, 8), 8)).to(torch.bfloat16)
    y = norm_leaky.instance_norm_leaky(x)
    y.backward(g)
    y_saved, rstd = norm_leaky.instance_norm_leaky_plain(x.detach())
    torch.testing.assert_close(y.detach(), y_saved, rtol=0, atol=0)
    torch.testing.assert_close(x.grad, norm_leaky.instance_norm_leaky_bwd_plain(g, y_saved, rstd),
                               rtol=0, atol=0)
