"""The bf16 `phased_conv_stats` kernel's epilogue rule on the CPU.

The kernel (csrc/conv_wgmma.cu, form (a)) computes the ungathered phased conv
on the (n+1)^3 grid and scatters each row of phase q's columns to
y[v' - q], masked to n^3; `phase_scatter_plain` states that rule row by
row. Here it is held against the 8 phase windows that the plain version of
`phased_conv_stats` gathers (`s2d.phase_windows`): exactly for y, at f32
summation-order tolerance for the sums. Catches an off-by-one in the mask
before any card run."""

import numpy as np
import pytest
import torch

from se_unet_airseg_tpu_torch.ops import conv_stats as pcs
from se_unet_airseg_tpu_torch.ops import s2d as ps2d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,co", [(3, 8), (3, 16), (5, 8), (5, 16)])
def test_phase_scatter_matches_phase_windows(n, co, dtype):
    b, m = 2, n + 1
    y_ext = torch.from_numpy(np.random.default_rng(n * co).standard_normal(
        (b, m, m, m, 8 * co)).astype(np.float32))
    y, s1, s2 = pcs.phase_scatter_plain(y_ext.to(dtype), n, co)
    win = torch.cat(ps2d.phase_windows(y_ext.to(dtype)), dim=-1)
    assert y.shape == (b, n ** 3, 8 * co) and y.dtype == dtype
    torch.testing.assert_close(y, win.reshape(b, n ** 3, 8 * co), rtol=0, atol=0)
    ref = win.float()
    assert s1.dtype == s2.dtype == torch.float32
    torch.testing.assert_close(s1, ref.sum(dim=(1, 2, 3)), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2, ref.square().sum(dim=(1, 2, 3)), rtol=1e-5, atol=1e-5)


def test_phase_scatter_of_the_ext_conv_is_the_plain_kernel():
    """The identity the kernel rests on: scattering phased_conv_ext's
    output gives phased_conv_stats_plain's y and sums, two inputs."""
    rng = np.random.default_rng(7)
    n, co = 4, 8
    xs = [torch.from_numpy(rng.standard_normal((2, n, n, n, c)).astype(np.float32))
          for c in (16, 8)]
    w_all = torch.from_numpy((0.2 * rng.standard_normal((8, 24, 8 * co))).astype(np.float32))
    b_all = torch.from_numpy((0.1 * rng.standard_normal(8 * co)).astype(np.float32))
    y_ext = ps2d.phased_conv_ext(xs, w_all.reshape(2, 2, 2, 24, 8 * co), b_all)
    got = pcs.phase_scatter_plain(y_ext, n, co)
    ref = pcs.phased_conv_stats_plain(xs, w_all, b_all)
    torch.testing.assert_close(got[0], ref[0].reshape(2, n ** 3, 8 * co), rtol=0, atol=0)
    for g, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)
