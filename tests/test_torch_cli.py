"""The port's predict and test CLIs (`--device cpu`) against their JAX
twins on the JAX CLI tests' fixture shape (48^3 cases, cube 32, step
16): the same files, of the same shape, dtype and geometry, the masks
within the engine tests' 0.1% of voxels of JAX's (both CLIs run bf16). The
checkpoints are one weight set (the port's, seeded, through the weight
bridge), saved by each package's own `save_params`; the LOG picks the
epoch."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from se_unet_airseg_tpu.io import read_nifti, write_nifti
from se_unet_airseg_tpu_torch.models import SEUNet, jax_params_from_torch
from se_unet_airseg_tpu_torch.models import SEUNetConfig as PortConfig

from test_torch_sliding_window import torch_threads  # noqa: F401
from test_train_integration import make_tube_case

SPACING, ORIGIN = (0.8, 0.8, 1.5), (10.0, -20.0, 30.0)
MASK_FRAC = 1e-3


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    """Cropped cases with priors, one raw CT, both packages' checkpoints
    of epochs 0 and 1, and a LOG in which epoch 1 scores higher."""
    from se_unet_airseg_tpu.pipeline.priors import save_skeletons_and_parses
    from se_unet_airseg_tpu.train.checkpoint import save_params as jax_save
    from se_unet_airseg_tpu_torch.train.checkpoint import save_params as port_save

    root = tmp_path_factory.mktemp("cli")
    data_dir, mask_dir, file_root = root / "AFTER_DATA" / "data", root / "AFTER_DATA" / "mask", \
        root / "data"
    for d in (data_dir, mask_dir, file_root, root / "ct", root / "LOG"):
        os.makedirs(d)
    rng = np.random.default_rng(3)
    hu, mask = make_tube_case(rng)
    write_nifti(str(data_dir / "CASE900data_cut.nii.gz"), (hu + 1024).astype(np.int16),
                SPACING, ORIGIN)
    write_nifti(str(mask_dir / "CASE900mask_cut.nii.gz"), mask, SPACING, ORIGIN)
    with open(file_root / "test.json", "w") as f:
        json.dump({"test": ["CASE900"]}, f)
    save_skeletons_and_parses(str(mask_dir), str(file_root / "test.json"),
                              str(file_root / "tree_parse_test"),
                              str(file_root / "skeleton_test"), split="test")
    hu = rng.normal(30.0, 10.0, (48, 48, 48)).astype(np.float32)
    hu[20:28, 20:28, 4:44] = -950.0
    write_nifti(str(root / "ct" / "PATIENT1.nii.gz"), hu.astype(np.int16), SPACING, ORIGIN)
    tree = SEUNet(PortConfig(), generator=torch.Generator().manual_seed(0)).params_tree()
    jp = jax_params_from_torch(tree)
    for ep in (0, 1):
        jax_save(jp, str(root / "saved_model" / "stage_three"), ep)
        port_save(tree, str(root / "saved_model" / "stage_three"), ep)
    with open(root / "LOG" / "log_stage_three.txt", "w") as f:
        for ep, v in ((0, 50.0), (1, 90.0)):
            f.write(f"epoch:{ep}\n" + ", ".join(f"{k}: {v} (0.0)" for k in (
                "TD", "BD", "DSC", "Pre", "Sen", "Spe")) + "\n\n")
    return root


def _run(main, argv, cwd):
    printed = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(printed):
            main(argv)
    finally:
        os.chdir(old)
    return printed.getvalue()


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_geometry(got_path, want_path):
    from se_unet_airseg_tpu_torch.io import read_nifti as pread

    got, want = pread(got_path), read_nifti(want_path)
    assert got.array.shape == want.array.shape and got.array.dtype == want.array.dtype
    assert got.spacing == want.spacing and got.origin == want.origin
    np.testing.assert_array_equal(got.direction, want.direction)
    return got.array, want.array


def _close_mask(got_path, want_path):
    """Geometry equal, and the mask's contents within the engine tests'
    bound: at most 0.1% of voxels differ."""
    got, want = _same_geometry(got_path, want_path)
    assert want.sum() > 0
    assert np.mean(got != want) <= MASK_FRAC


def test_test_cli_matches_jax(cli_env):
    from se_unet_airseg_tpu.cli.test import main as jax_main
    from se_unet_airseg_tpu_torch.cli.test import main as port_main

    root = cli_env
    common = ["--data_root", str(root / "AFTER_DATA"), "--file_path",
              str(root / "data" / "test.json"), "--file_root", str(root / "data"),
              "--log_path", str(root / "LOG" / "log_stage_three.txt"),
              "--model_dir", str(root / "saved_model" / "stage_three"),
              "--cube", "32", "--step", "16"]
    outs = {}
    for pkg, main, extra in (("port", port_main, ["--device", "cpu"]), ("jax", jax_main, [])):
        os.makedirs(root / pkg)
        outs[pkg] = _run(main, common + extra + [
            "--result_savepath", str(root / pkg / "test_result"),
            "--testlog_savepath", str(root / pkg / "LOG" / "testlog.txt")], root / pkg)
    # the LOG's best epoch picks each package's own checkpoint
    assert "best epoch: 1 -> " + str(root / "saved_model" / "stage_three" / "SE_UNet_1.pt") \
        in outs["port"]
    assert ".msgpack" in outs["jax"]
    assert _files(root / "port") == _files(root / "jax")
    assert "test_result/stage_three/CASE900.nii.gz" in _files(root / "port")
    _close_mask(str(root / "port" / "test_result" / "stage_three" / "CASE900.nii.gz"),
                str(root / "jax" / "test_result" / "stage_three" / "CASE900.nii.gz"))
    assert len((root / "port" / "LOG" / "testlog.txt").read_text().splitlines()) == 1


def test_predict_cli_matches_jax(cli_env, tmp_path):
    from se_unet_airseg_tpu.cli.predict import main as jax_main
    from se_unet_airseg_tpu_torch.cli.predict import main as port_main

    model = cli_env / "saved_model" / "stage_three" / "SE_UNet_1"
    for pkg, main, argv in (("port", port_main, ["--model", f"{model}.pt", "--device", "cpu"]),
                            ("jax", jax_main, ["--model", f"{model}.msgpack"])):
        _run(main, argv + ["--ct_dir", str(cli_env / "ct"), "--save_path",
                           str(tmp_path / pkg), "--cube", "32", "--step", "16"], tmp_path)
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    # the case name is the file name up to "data.nii": here all of it
    assert {"PATIENT1.nii.gz_pred_mask.nii.gz", "PATIENT1.nii.gz_seg.stl"} <= set(files)
    for f in files:
        if f.endswith("_pred_mask.nii.gz"):
            _close_mask(str(tmp_path / "port" / f), str(tmp_path / "jax" / f))
        elif f.endswith(".nii.gz"):
            np.testing.assert_array_equal(
                *_same_geometry(str(tmp_path / "port" / f), str(tmp_path / "jax" / f)))
