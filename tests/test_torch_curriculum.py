"""The port's whole curriculum through its training CLI, on the CPU:
`cli.train.main` -> `run_full_curriculum` on three 48^3 tube cases (two
train, one val), cube 32, batch 2, one epoch per stage, float32, remat
at the CLI's default, after the port's own LIB weights, skeletons and
parses. Asserts the on-disk contract that
tests/test_full_curriculum.py asserts of the JAX package, with the
port's `.pt` parameter files for `.msgpack`, and that every stage's
steps ran with finite losses."""

import json
import math
import os

import numpy as np
import pytest

from se_unet_airseg_tpu_torch.cli import train as cli_train
from se_unet_airseg_tpu_torch.io import write_nifti
from se_unet_airseg_tpu_torch.pipeline.orchestrate import PipelineConfig, run_full_curriculum
from se_unet_airseg_tpu_torch.pipeline.priors import (
    save_lib_weights,
    save_skeletons_and_parses,
)
from se_unet_airseg_tpu_torch.train import stages as pstages

from test_torch_sliding_window import torch_threads  # noqa: F401
from test_train_integration import make_tube_case


def write_env(root):
    """AFTER_DATA/{data,mask} of three tube cases, base_dict.json and
    test.json, and the priors the stages read before any prediction."""
    data_dir, mask_dir = root / "AFTER_DATA" / "data", root / "AFTER_DATA" / "mask"
    file_root = root / "data"
    for d in (data_dir, mask_dir, file_root):
        os.makedirs(d)
    rng = np.random.default_rng(1)
    names = [f"CASE{i:03d}" for i in range(3)]
    for n in names:
        hu, mask = make_tube_case(rng)
        write_nifti(str(data_dir / f"{n}data_cut.nii.gz"), (hu + 1024).astype(np.int16))
        write_nifti(str(mask_dir / f"{n}mask_cut.nii.gz"), mask)
    with open(file_root / "base_dict.json", "w") as f:
        json.dump({"0": {"train": names[:2], "val": names[2:]}}, f)
    with open(file_root / "test.json", "w") as f:
        json.dump({"test": names[2:]}, f)
    save_lib_weights(str(mask_dir), str(file_root / "LIB_weight"), device="cpu")
    for split, suffix in (("train", ""), ("val", "_val")):
        save_skeletons_and_parses(str(mask_dir), str(file_root / "base_dict.json"),
                                  str(file_root / f"tree_parse{suffix}"),
                                  str(file_root / f"skeleton{suffix}"), split=split)
    return names, file_root


def test_cli_train_runs_the_curriculum(tmp_path, monkeypatch):
    names, file_root = write_env(tmp_path)
    losses = []
    make = pstages.make_resilient_step

    def watched(*a, **k):
        step = make(*a, **k)

        def run(state, batch, *args, **kw):
            state, aux = step(state, batch, *args, **kw)
            losses.append((batch["image"].shape[0], float(aux["loss"])))
            return state, aux
        return run

    monkeypatch.setattr(pstages, "make_resilient_step", watched)
    monkeypatch.chdir(tmp_path)
    cli_train.main([
        "--data_root", str(tmp_path / "AFTER_DATA"), "--file_root", str(file_root),
        "--saved_model", str(tmp_path / "saved_model"), "--log_dir", str(tmp_path / "LOG"),
        "--epochs", "1", "1", "1", "--batch_size", "2", "--cube", "32", "--f32",
        "--device", "cpu",
    ])

    for stage in ("stage_one", "stage_two", "stage_three"):
        assert os.path.exists(tmp_path / "saved_model" / stage / "SE_UNet_0.pt"), stage
        assert os.path.exists(tmp_path / "LOG" / f"log_{stage}.txt")
    for n in names:
        for d in ("pred_1", "pred_2"):
            assert os.path.exists(file_root / d / f"{n}.nii.gz"), (d, n)
        for d in ("BR_weight", "br_skel"):
            assert os.path.exists(file_root / d / f"{n}.npy"), (d, n)
    assert os.path.exists(tmp_path / "LOG" / "log_stage_two.txt.dti")
    assert os.path.exists(tmp_path / "LOG" / "log_stage_three.txt.dti")
    # stage 1: one B=2 step per train volume; stages 2/3 add the replay's
    # B=1 steps over the cached crops
    limit = int(2 * 2 * 0.3)
    assert [b for b, _ in losses] == [2, 2] + ([2, 2] + [1] * limit) * 2
    assert all(math.isfinite(v) for _, v in losses)


def test_curriculum_defaults_to_cuda(tmp_path):
    cfg = PipelineConfig(data_root=str(tmp_path), file_root=str(tmp_path),
                         saved_model=str(tmp_path / "m"), log_dir=str(tmp_path / "L"))
    assert cfg.device is None and cfg.model_cfg.remat
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_full_curriculum(cfg)
