"""The port's plain device ops (se_unet_airseg_tpu_torch.ops) against
their JAX counterparts on the same numpy inputs, the device rule of the
entry points, and the port's isolation from JAX."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_unet_airseg_tpu import ops as jops
from se_unet_airseg_tpu.ops.resize import _interp_matrix as jax_interp_matrix
from se_unet_airseg_tpu_torch import ops
from se_unet_airseg_tpu_torch.ops.resize import _interp_matrix
from se_unet_airseg_tpu_torch.utils import resolve_device

ATOL, RTOL = 2e-6, 1e-5
REPO = Path(__file__).resolve().parent.parent


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def test_hu_dual_window():
    hu = (np.random.default_rng(0).random((4, 6, 5)) * 3000 - 1500).astype(np.float32)
    # XLA may divide by a multiply with the reciprocal: one f32 ulp
    _close(ops.hu_dual_window(torch.from_numpy(hu)), jops.hu_dual_window(jnp.asarray(hu)),
           atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("k,padding,dilation,groups,bias", [
    (3, 1, 1, 1, True),
    (3, 2, 2, 1, True),
    (3, (1, 0, 1), 1, 2, False),
    (3, ((1, 1), (1, 1), (1, 8)), 1, 1, True),
    (1, 0, 1, 1, False),
])
def test_conv3d(k, padding, dilation, groups, bias):
    ci, co = 8, 6
    x = _rand(1, (2, 7, 6, 5, ci))
    w = _rand(2, (k, k, k, ci // groups, co), 0.2)
    b = _rand(3, (co,)) if bias else None
    jpad = padding
    if isinstance(padding, tuple) and isinstance(padding[0], int):
        jpad = [(p, p) for p in padding]
    ref = jops.conv3d(jnp.asarray(x), jnp.asarray(w),
                      None if b is None else jnp.asarray(b),
                      padding=jpad, dilation=dilation, groups=groups)
    got = ops.conv3d(torch.from_numpy(x), torch.from_numpy(w),
                     None if b is None else torch.from_numpy(b),
                     padding=padding, dilation=dilation, groups=groups)
    _close(got, ref, atol=1e-5, rtol=1e-5)


def test_instance_norm_and_leaky_relu():
    x = _rand(4, (2, 5, 6, 7, 3), 3.0) + 1.0
    ref = jops.leaky_relu(jops.instance_norm(jnp.asarray(x)))
    _close(ops.leaky_relu(ops.instance_norm(torch.from_numpy(x))), ref)


def test_leaky_relu_bf16_slope_rounding():
    x = _rand(5, (64,), 5.0)
    ref = jops.leaky_relu(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32)
    got = ops.leaky_relu(torch.from_numpy(x).to(torch.bfloat16)).float()
    _close(got, ref, atol=0, rtol=0)


def test_max_pool3d():
    x = _rand(6, (2, 8, 6, 4, 3))
    _close(ops.max_pool3d(torch.from_numpy(x)), jops.max_pool3d(jnp.asarray(x)),
           atol=0, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(4, 8), (2, 16), (5, 10), (1, 4)])
def test_interp_matrix(n_in, n_out):
    np.testing.assert_array_equal(_interp_matrix(n_in, n_out),
                                  jax_interp_matrix(n_in, n_out))


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_upsample_trilinear(scale):
    x = _rand(7, (2, 4, 3, 5, 3))
    ref = jops.upsample_trilinear(jnp.asarray(x), scale)
    _close(ops.upsample_trilinear(torch.from_numpy(x), scale), ref)


def test_upsample_trilinear_matches_torch_interpolate():
    x = torch.from_numpy(_rand(8, (1, 4, 4, 4, 2)))
    want = torch.nn.functional.interpolate(
        x.permute(0, 4, 1, 2, 3), scale_factor=2, mode="trilinear",
        align_corners=True).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(ops.upsample_trilinear(x, 2), want, atol=1e-6, rtol=1e-5)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke, loads no JAX
    module, no module of the JAX package, and none of flax, optax or
    msgpack (the GPU host has none of them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import se_unet_airseg_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0].startswith('jax')\n"
        "       or m.split('.')[0] in ('flax', 'optax', 'msgpack')\n"
        "       or m == 'se_unet_airseg_tpu' or m.startswith('se_unet_airseg_tpu.')]\n"
        "print(len([m for m in sys.modules if m.startswith('se_unet_airseg_tpu_torch')]))\n"
        "sys.exit('loaded: ' + ', '.join(bad) if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[-1]) > 10  # the port's modules did load
