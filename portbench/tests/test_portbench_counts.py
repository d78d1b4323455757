"""The yardstick's arithmetic against counts made by hand."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench import counts
from portbench.reference import spec


def test_one_block_by_hand():
    # ec3: a 3x3x3 conv 16 -> 32 on the full 128^3 grid, 2 operations a multiply-add
    ec3 = [row for row in counts.conv_layers(128) if row[:2] == ("ec3", "main")]
    assert ec3 == [("ec3", "main", 16, 32, 27, 128 ** 3)]
    assert 2 * 16 * 32 * 27 * 128 ** 3 == 57_982_058_496
    # dc5 reads the 64-channel concat at full resolution: the largest conv
    dc5 = next(r for r in counts.conv_layers(128) if r[:2] == ("dc5", "main"))
    assert 2 * dc5[2] * dc5[3] * dc5[4] * dc5[5] == 231_928_233_984


def test_forward_and_train_totals():
    fwd = counts.forward_flops(128)
    assert fwd == pytest.approx(0.630569566208e12, rel=1e-12)
    conv3 = counts.forward_flops(128, only_3x3x3=True)
    assert conv3 == pytest.approx(0.613341462528e12, rel=1e-12)
    # training: three times the forward less the input gradient of the blocks
    # that read the network's input
    no_dgrad = sum(2.0 * ci * co * t * v for n, _, ci, co, t, v in counts.conv_layers(128)
                   if n in spec.TAKES_INPUT)
    assert counts.train_flops(128) == pytest.approx(3 * fwd - no_dgrad, rel=1e-12)


def test_dc62_is_not_counted():
    assert not [r for r in counts.conv_layers(128) if r[0] == "dc62"]


def test_conv3_least_time_takes_the_larger_bound_conv_by_conv():
    crop, batch = 32, 2
    want = 0.0
    for _, _, ci, co, taps, v in counts.conv_layers(crop):
        if taps == 27:
            nbytes = 2 * (batch * ci * v + ci * co * taps + batch * co * v)
            want += max(2.0 * batch * ci * co * taps * v / 989e12, nbytes / 3.35e12)
    assert counts.conv3_least_s(crop, batch) == pytest.approx(want, rel=1e-12)


def test_epilogue_bytes_by_hand_and_against_the_card_smokes_bound():
    # K1's ten blocks: (grid voxels, channels, SE gates); bf16 in and out, the
    # (batch, 8C) float32 scale and shift, the gate vectors
    blocks = [(128 ** 3, 8, 1), (128 ** 3, 16, 1), (128 ** 3, 32, 1), (128 ** 3, 32, 0),
              (128 ** 3, 32, 0), (64 ** 3, 32, 2), (64 ** 3, 64, 2), (64 ** 3, 64, 0),
              (64 ** 3, 64, 0), (64 ** 3, 32, 0)]
    want = sum((2 * 8 * v * c + g * c) * 2 + 2 * 8 * 8 * c * 4 for v, c, g in blocks)
    got = counts.epilogue_bytes("gathered_epilogue", 8, 128)
    assert got == want
    # chip_smoke.py's bound for the same pass: 3.045 ms at 3.35 TB/s (PERF.md)
    assert got / 3.35e12 * 1e3 == pytest.approx(3.045, rel=2e-3)
    assert counts.epilogue_bytes("phased_epilogue", 8, 128) / 3.35e12 * 1e3 == \
        pytest.approx(1.282, rel=2e-3)


def test_weights_follow_the_default_init_and_the_seed():
    a = spec.make_weights(5, "cpu")
    b = spec.make_weights(5, "cpu")
    c = spec.make_weights(6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["ec1.conv1.weight"], c["ec1.conv1.weight"])
    w = a["dc5.conv1.weight"]
    assert w.shape == (32, 64, 3, 3, 3)
    assert float(w.abs().max()) <= 1 / math.sqrt(64 * 27)
    assert sum(t.numel() for t in a.values()) == sum(
        math.prod(s) for _, s, _ in spec.leaf_shapes())
    big = spec.make_weights(2**31 + 12345, "cpu")  # seeds past 32 bits
    assert torch.isfinite(big["ec1.conv1.weight"]).all()


def test_phantom_shape_type_and_seed():
    gen = torch.Generator().manual_seed(3)
    vol, lumen = counts.phantom((40, 32, 48), gen, "cpu")
    assert vol.shape == (40, 32, 48) and vol.dtype == np.int16
    assert lumen.shape == (40, 32, 48) and lumen.dtype == torch.bool and lumen.any()
    again, _ = counts.phantom((40, 32, 48), torch.Generator().manual_seed(3), "cpu")
    assert np.array_equal(vol, again)
