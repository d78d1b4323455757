"""The plain reference against the program on the CPU at small sizes, in
float32: the forward, the whole-volume trits, the stage-1 step, and the
stage-1 data path. The program runs its plain (CPU) kernels here."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import counts, program
from portbench.drivers import train_stage1
from portbench.reference import stage1_data, volume
from portbench.reference.seunet import forward
from portbench.reference.spec import make_weights
from se_unet_airseg_tpu_torch.data.datasets import Stage1Crops
from se_unet_airseg_tpu_torch.models.se_unet import SEUNetConfig, apply, apply_fast
from se_unet_airseg_tpu_torch.ops.lib_filter import lib_weight_map

F32 = SEUNetConfig()


@pytest.fixture(scope="module")
def sd():
    torch.manual_seed(0)
    return make_weights(7, "cpu")


@pytest.mark.parametrize("fast", [True, False])
def test_forward_matches_the_program(sd, fast):
    x = torch.rand((2, 32, 32, 32, 2), generator=torch.Generator().manual_seed(1))
    tree = program.params_from_state_dict(sd)
    fn = apply_fast if fast else apply
    with torch.no_grad():
        en, de = fn(tree, x, cfg=F32)
        r_en, r_de = forward(sd, x.permute(0, 4, 1, 2, 3))
    assert torch.allclose(en[..., 0], r_en[:, 0], atol=2e-5)
    assert torch.allclose(de[..., 0], r_de[:, 0], atol=2e-5)


def test_volume_trits_match_the_runner(sd):
    gen = torch.Generator().manual_seed(2)
    vol, _ = counts.phantom((48, 40, 56), gen, "cpu")
    kw = dict(cube=32, step=16, batch=3)
    runner = program.SlidingWindowRunner(program.params_from_state_dict(sd), F32, device="cpu",
                                         **kw)
    got = runner.predict_trits(vol, h_thresh=0.5, l_thresh=0.4, hu_shift=-1024.0)
    ref = volume.predict_trits(sd, vol, h=0.5, l=0.4, hu_shift=-1024.0, device="cpu", **kw)
    assert got.shape == ref.shape == vol.shape
    assert np.count_nonzero(got != ref) == 0


def test_positions_pad_with_the_first_tile():
    pos = volume.positions((48, 40, 56), 32, 16, 5)  # 12 tiles, padded to 15
    assert len(pos) == 15 and pos[-3:] == [(0, 0, 0)] * 3 == pos[:1] * 3
    assert (16, 8, 24) in pos  # the last window of each axis ends at the edge


def test_stage1_step_matches_the_program(sd):
    mix = {"lr": 1e-4, "batch": 2, "cube": 32}
    gen = torch.Generator().manual_seed(3)
    batches = []
    rng = np.random.default_rng(4)
    for shape in ((48, 40, 56), (40, 48, 40), (48, 48, 48)):
        stored, lumen = counts.phantom(shape, gen, "cpu")
        lib = stage1_data.lib_weight(lumen).numpy().astype(np.float16)
        hu = stored.astype(np.float32) - 1024.0
        batches.append(stage1_data.volume_batch(hu, lumen.numpy().astype(np.uint8), lib, rng,
                                                2, 32))
    draws = train_stage1.Draws(5, "cpu", 2)
    prog = train_stage1.Program(F32, mix, sd, draws, "cpu")
    losses, grad1, theta, kept = prog.checked_steps(iter(batches))
    assert len(kept) == 3
    ref = train_stage1.reference_steps(sd, batches, draws.kept, "cpu")
    got = train_stage1.numbers(sd, prog.theta0, losses, grad1, theta, ref)
    assert got["loss_gap"][0] < 1e-5
    assert got["grad_gap"][0] < 1e-2 and got["grad_gap_median"][0] < 1e-4
    assert "grad_gap_vs_bf16" not in got  # only with the bf16 reference's unit
    assert got["change_gap_median"][0] < 1e-2


def test_lib_weight_matches_the_program():
    label = torch.zeros((20, 24, 28), dtype=torch.bool)
    label[5:15, 10:14, 3:25] = True
    assert torch.equal(stage1_data.lib_weight(label),
                       lib_weight_map(label.numpy().astype(np.float32), device="cpu"))


def test_stage1_batches_match_the_programs_crops(tmp_path):
    gen = torch.Generator().manual_seed(6)
    names = []
    for i, shape in enumerate(((48, 40, 56), (40, 48, 44))):
        stored, lumen = counts.phantom(shape, gen, "cpu")
        lib = stage1_data.lib_weight(lumen).numpy()
        stage1_data.write_case(str(tmp_path), f"c{i}", stored, lumen.numpy().astype(np.uint8),
                               lib)
        names.append(f"c{i}")
    split = tmp_path / "split.json"
    stage1_data.write_split(str(split), names)
    ds = Stage1Crops(str(split), str(tmp_path), str(tmp_path), batch_size=3, cube=32,
                     aug=True, seed=2**31 + 99)
    got = [b for _ in range(2) for b in ds]  # two epochs
    ref = stage1_data.epoch_batches(str(tmp_path), names, np.random.default_rng(2**31 + 99),
                                    3, 32, 4)
    for g, r in zip(got, ref):
        for k in ("image", "label", "weight"):
            assert g[k].dtype == r[k].dtype and np.array_equal(g[k], r[k]), k
