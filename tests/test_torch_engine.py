"""The port's inference entry points (`infer/engine.py`) against the JAX
package's, on the CPU, in two layers.

(a) Host side, exact: the same trit field through both packages' codec
    decode, `_finish_binarize`, `border_suppress`, `maximum_3d` and
    `evaluation_case` gives identical masks and metrics.
(b) End to end: `validate` (stage 1, and stage 2 with DTI and a `pred_1`
    prior), `run_test` and `network_prediction` on one fixture directory
    (32x32x48 tube cases, cube 32, step 16, the entry points' batch 1, float32, the
    same weights through the bridge). Train mode gets the JAX DropLayer
    draws: validate's key fold_in(key(0), epoch), run_test's key(0), each
    folded with the case index, then per tile batch as the runner folds
    it. Written masks differ in at most 0.1% of voxels (a voxel whose
    averaged score lies within float32 rounding of a threshold may flip,
    and DTI and the largest component carry a flip further); every
    metric (a percentage) lies within 0.5 of JAX's; written NIfTI
    metadata and the LOG / test-log line forms are equal.

Also: a checkpoint saved with `save_params` and loaded with `load_params`
predicts the same mask as the tree it was saved from.
"""

import contextlib
import functools
import io
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from se_unet_airseg_tpu.infer import engine as jeng
from se_unet_airseg_tpu.infer import sliding_window as jsw
from se_unet_airseg_tpu.infer.sliding_window import SlidingWindowRunner as JaxRunner
from se_unet_airseg_tpu.io import read_nifti, write_nifti
from se_unet_airseg_tpu.models.se_unet import SEUNetConfig as JaxConfig
from se_unet_airseg_tpu.pipeline import preprocess as jprep
from se_unet_airseg_tpu_torch.data import pad_positions_to_batch, tile_positions
from se_unet_airseg_tpu_torch.infer import engine as peng
from se_unet_airseg_tpu_torch.infer import sliding_window as psw
from se_unet_airseg_tpu_torch.io import read_nifti as pread
from se_unet_airseg_tpu_torch.models import (
    SEUNet,
    SEUNetConfig,
    jax_params_from_torch,
    state_dict_from_jax_params,
)
from se_unet_airseg_tpu_torch.pipeline import preprocess as pprep
from se_unet_airseg_tpu_torch.train.checkpoint import load_params, save_params

from test_torch_sliding_window import jax_drop_draws, torch_threads  # noqa: F401
from test_train_integration import make_tube_case

CUBE, STEP, SHAPE = 32, 16, (32, 32, 48)
NAMES = ["CASE900", "CASE901"]
SPACING, ORIGIN = (0.7, 0.75, 1.25), (-120.5, 33.0, 410.0)
MASK_FRAC, METRIC_ATOL = 1e-3, 0.5
LINE = re.compile(r"^TD: \d+\.\d{4} \(\d+\.\d{4}\), BD: \d+\.\d{4} \(\d+\.\d{4}\), "
                  r"DSC: \d+\.\d{4} \(\d+\.\d{4}\), Pre: \d+\.\d{4} \(\d+\.\d{4}\), "
                  r"Sen: \d+\.\d{4} \(\d+\.\d{4}\), Spe: \d+\.\d{4} \(\d+\.\d{4}\)$")
N_BATCHES = len(pad_positions_to_batch(tile_positions(SHAPE, CUBE, STEP), 1))


def _case_draws(rng, n_cases=len(NAMES)):
    """The port's `drop_draws` for an entry point whose JAX key is `rng`."""
    return [jax_drop_draws(jax.random.fold_in(rng, i), N_BATCHES, 1) for i in range(n_cases)]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """AFTER_DATA cases, val/test priors (the JAX package's helpers), a
    pred_1 prior, a raw CT, and one weight set (the port's, seeded) in
    both layouts."""
    from se_unet_airseg_tpu.pipeline.priors import save_skeletons_and_parses

    root = tmp_path_factory.mktemp("engine")
    data_dir, mask_dir, file_root = root / "AFTER_DATA" / "data", root / "AFTER_DATA" / "mask", \
        root / "data"
    for d in (data_dir, mask_dir, file_root / "pred_1", root / "raw"):
        os.makedirs(d)
    rng = np.random.default_rng(3)
    for n in NAMES:
        hu, mask = make_tube_case(rng, SHAPE)
        write_nifti(str(data_dir / f"{n}data_cut.nii.gz"), (hu + 1024).astype(np.int16),
                    SPACING, ORIGIN)
        write_nifti(str(mask_dir / f"{n}mask_cut.nii.gz"), mask, SPACING, ORIGIN)
        # a stage-1 prediction that found the upper half of the airway
        write_nifti(str(file_root / "pred_1" / f"{n}.nii.gz"),
                    mask * (np.arange(SHAPE[2]) < 24)[None, None, :].astype(np.uint8))
    hu, _ = make_tube_case(rng, SHAPE)
    write_nifti(str(root / "raw" / "PATIENT7data.nii.gz"), hu.astype(np.int16), SPACING,
                ORIGIN)
    with open(file_root / "base_dict.json", "w") as f:
        json.dump({"0": {"train": [], "val": NAMES}}, f)
    with open(file_root / "test.json", "w") as f:
        json.dump({"test": NAMES}, f)
    for split, js in (("val", "base_dict.json"), ("test", "test.json")):
        save_skeletons_and_parses(str(mask_dir), str(file_root / js),
                                  str(file_root / f"tree_parse_{split}"),
                                  str(file_root / f"skeleton_{split}"), split=split)
    tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(0)).params_tree()
    jp = jax_params_from_torch(tree)
    return {"root": root, "data_root": str(root / "AFTER_DATA"), "file_root": str(file_root),
            "ct": str(root / "raw" / "PATIENT7data.nii.gz"), "jax": jp, "port": tree}


def _drive(eng, params, cfg, env, out, kw_val, kw_test, device):
    """validate (stage 1; stage 2 with DTI; one runner for both, as the
    stage drivers reuse theirs), run_test and network_prediction of one
    package into `out`; returns their results and what they printed."""
    os.makedirs(out)
    dev = {} if device is None else {"device": device}
    printed = io.StringIO()
    cwd = os.getcwd()
    os.chdir(out)  # run_test's boxplot lands in the working directory
    try:
        with contextlib.redirect_stdout(printed):
            runner = eng.SlidingWindowRunner(params, cfg, train_mode=True, cube=CUBE, step=STEP,
                                             **dev)
            val = [eng.validate(params, cfg, NAMES, env["data_root"], env["file_root"], epoch,
                                str(out / f"log{stage}.txt"), dti=stage == 2, stage=stage,
                                runner=runner, **kw_val(epoch))
                   for stage, epoch in ((1, 3), (2, 4))]
            test = eng.run_test(params, cfg, NAMES, env["data_root"], env["file_root"],
                                str(out / "testlog.txt"), str(out / "test_result"),
                                cube=CUBE, step=STEP, **kw_test, **dev)
            pred = eng.network_prediction(params, cfg, env["ct"], str(out / "pred"),
                                          cube=CUBE, step=STEP, **dev)
    finally:
        os.chdir(cwd)
    return {"val": val, "test": test, "pred": pred, "printed": printed.getvalue()}


@pytest.fixture(scope="module")
def jax_run(env):
    """The JAX drivers on the reference-layout forward (`fast=False`):
    on these near-uniform soft-tissue volumes JAX's float32 `apply_fast`
    departs from a float64 evaluation by up to about 2e-4, which puts
    far more voxels within reach of a threshold, while its `apply` and
    the port's `apply_fast` stay within 5e-5 and 1e-5
    (`test_scores_against_float64`)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeng, "SlidingWindowRunner", functools.partial(JaxRunner, fast=False))
        return _drive(jeng, env["jax"], JaxConfig(), env, env["root"] / "jax",
                      lambda epoch: {}, {}, None)


@pytest.fixture(scope="module")
def port_run(env):
    def kw_val(epoch):
        return {"drop_draws": _case_draws(jax.random.fold_in(jax.random.key(0), epoch))}

    return _drive(peng, env["port"], SEUNetConfig(), env, env["root"] / "port", kw_val,
                  {"drop_draws": _case_draws(jax.random.key(0))}, "cpu")


def _close_masks(got_path, want_path, dtype):
    got, want = pread(got_path), read_nifti(want_path)
    assert got.array.dtype == want.array.dtype == dtype
    assert got.array.shape == want.array.shape
    assert got.spacing == want.spacing and got.origin == want.origin
    np.testing.assert_array_equal(got.direction, want.direction)
    assert want.array.sum() > 0
    assert np.mean(got.array != want.array) <= MASK_FRAC
    return got.array


def _close_metrics(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


def _log_numbers(line: str):
    return [float(v) for v in re.findall(r"\d+\.\d{4}", line)]


@pytest.mark.parametrize("stage", [1, 2])
def test_validate_matches_jax(env, jax_run, port_run, stage):
    got, want = port_run["val"][stage - 1], jax_run["val"][stage - 1]
    for g, w in zip(got[:2], want[:2]):  # TD, BD means (percentages)
        assert abs(g - w) <= METRIC_ATOL
    for g, w in zip(got[2:], want[2:]):  # random / hard Dice (fractions)
        assert abs(g - w) <= METRIC_ATOL / 100
    if stage == 2:
        assert 0 < want[2] and 0 < want[3]
    else:
        assert got[2:] == want[2:] == (0.0, 0.0)
    p_log = (env["root"] / "port" / f"log{stage}.txt").read_text().split("\n")
    j_log = (env["root"] / "jax" / f"log{stage}.txt").read_text().split("\n")
    epoch = 2 + stage
    assert p_log[0] == j_log[0] == f"epoch:{epoch}" and p_log[2:] == j_log[2:] == ["", ""]
    assert LINE.match(p_log[1]) and LINE.match(j_log[1])
    np.testing.assert_allclose(_log_numbers(p_log[1]), _log_numbers(j_log[1]),
                               atol=METRIC_ATOL)
    p_side = json.loads((env["root"] / "port" / f"log{stage}.txt.jsonl").read_text())
    j_side = json.loads((env["root"] / "jax" / f"log{stage}.txt.jsonl").read_text())
    assert p_side["epoch"] == j_side["epoch"] == epoch
    _close_metrics({k: v for k, v in p_side.items() if k != "epoch"},
                   {k: v for k, v in j_side.items() if k != "epoch"})


def test_run_test_matches_jax(env, jax_run, port_run):
    for name in NAMES:
        _close_masks(str(env["root"] / "port" / "test_result" / "stage_three" / f"{name}.nii.gz"),
                     str(env["root"] / "jax" / "test_result" / "stage_three" / f"{name}.nii.gz"),
                     np.int8)
    assert len(port_run["test"]) == len(jax_run["test"]) == len(NAMES)
    for g, w in zip(port_run["test"], jax_run["test"]):
        _close_metrics(g, w)
    p_line = (env["root"] / "port" / "testlog.txt").read_text().splitlines()
    j_line = (env["root"] / "jax" / "testlog.txt").read_text().splitlines()
    assert len(p_line) == len(j_line) == 1 and LINE.match(p_line[0])
    np.testing.assert_allclose(_log_numbers(p_line[0]), _log_numbers(j_line[0]),
                               atol=METRIC_ATOL)
    assert sorted(os.listdir(env["root"] / "port")) == sorted(os.listdir(env["root"] / "jax"))
    # the per-case lines each package printed have the same form
    form = [re.sub(r"\d+\.\d{4}", "x", ln) for ln in port_run["printed"].splitlines()]
    assert form == [re.sub(r"\d+\.\d{4}", "x", ln) for ln in jax_run["printed"].splitlines()]


def test_network_prediction_matches_jax(env, jax_run, port_run):
    got, want = port_run["pred"], jax_run["pred"]
    assert os.path.basename(got) == os.path.basename(want) == "PATIENT7_pred_mask.nii.gz"
    mask = _close_masks(got, want, np.uint8)
    assert sorted(os.listdir(os.path.dirname(got))) == sorted(os.listdir(os.path.dirname(want)))
    stl = os.path.join(os.path.dirname(got), "PATIENT7_seg.stl")
    assert mask.sum() > 0 and os.path.getsize(stl) > 84
    d = "PATIENT7data_cut.nii.gz"
    a = pread(os.path.join(os.path.dirname(got), d))
    b = read_nifti(os.path.join(os.path.dirname(want), d))
    np.testing.assert_array_equal(a.array, b.array)
    assert a.spacing == b.spacing and a.origin == b.origin


def test_checkpoint_round_trip_predicts_the_same(env, port_run, tmp_path):
    path = save_params(env["port"], str(tmp_path / "saved_model"), 7)
    assert os.path.basename(path) == "SE_UNet_7.pt"
    loaded = load_params(path)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(env["port"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    out = peng.network_prediction(loaded, SEUNetConfig(), env["ct"], str(tmp_path / "pred"),
                                  cube=CUBE, step=STEP, device="cpu")
    np.testing.assert_array_equal(pread(out).array, pread(port_run["pred"]).array)
    # a reference .pth state_dict loads to the same tree
    torch.save(state_dict_from_jax_params(env["jax"]), tmp_path / "ref.pth")
    for a, b in zip(jax.tree.leaves(load_params(str(tmp_path / "ref.pth"))),
                    jax.tree.leaves(env["port"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_scores_against_float64(env):
    """The averaged scores of a tube case, eval mode: the port's float32
    `apply_fast` within 1e-5 of the port in float64, JAX's `apply` within
    5e-5, JAX's `apply_fast` within 1e-3 (its float32 statistics lose
    digits over near-uniform tissue)."""
    vol = read_nifti(os.path.join(env["data_root"], "data", NAMES[0] + "data_cut.nii.gz")).array
    kw = dict(cube=CUBE, step=STEP)
    tree64 = jax.tree.map(lambda t: t.double(), env["port"])
    f64 = psw.SlidingWindowRunner(tree64, SEUNetConfig(compute_dtype=torch.float64),
                                  device="cpu", **kw).predict_hu(vol, hu_shift=-1024.0)
    port = psw.SlidingWindowRunner(env["port"], SEUNetConfig(), device="cpu", **kw)
    assert np.abs(port.predict_hu(vol, hu_shift=-1024.0) - f64).max() <= 1e-5
    for fast, atol in ((False, 5e-5), (True, 1e-3)):
        got = JaxRunner(env["jax"], JaxConfig(), fast=fast, **kw).predict_hu(vol, hu_shift=-1024.0)
        assert np.abs(got - f64).max() <= atol, fast


def _score_field(seed: int, label: np.ndarray):
    """A smooth averaged-score field that follows the airway, float32."""
    r = np.random.default_rng(seed)
    f = r.random(SHAPE).astype(np.float32)
    for ax in range(3):
        f = (f + np.roll(f, 1, ax) + np.roll(f, -1, ax)) / 3
    return (0.25 + 0.5 * (f - f.min()) / (f.max() - f.min()) * 0.6
            + 0.3 * label).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dti_on,l_thresh", [(True, 0.4), (True, 0.35), (False, 0.4)])
def test_host_side_matches_jax_exactly(env, name, dti_on, l_thresh):
    """Same trits -> same mask and metrics: the codec decode and
    threshold or DTI, border suppression, maximum_3d, evaluation_case."""
    label = read_nifti(os.path.join(env["data_root"], "mask", name + "mask_cut.nii.gz")).array
    avg = _score_field(NAMES.index(name) + int(100 * l_thresh), label)
    ph, pl = (0.5, l_thresh) if dti_on else (0.5, 0.5)
    ones = np.ones(SHAPE, np.float32)
    p_out = psw.SlidingWindowRunner._trit_summary(torch.from_numpy(avg), torch.from_numpy(ones),
                                                  ph, pl) + (SHAPE, SHAPE)
    j_out = tuple(jsw.SlidingWindowRunner._trit_summary(avg.reshape(-1), ones.reshape(-1),
                                                        ph, pl)) + (SHAPE, SHAPE)
    got = peng._finish_binarize((dti_on, 0.5, l_thresh, p_out))
    want = jeng._finish_binarize((dti_on, 0.5, l_thresh, j_out, None))
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size
    got, want = peng.border_suppress(got), jeng.border_suppress(want)
    np.testing.assert_array_equal(got, want)
    got, want = pprep.largest_cc_midslice_fallback(got), jprep.largest_cc_midslice_fallback(want)
    np.testing.assert_array_equal(got, want)
    with contextlib.redirect_stdout(io.StringIO()):
        m_got = peng.evaluation_case(got, label, name, env["file_root"], "_test")
        m_want = jeng.evaluation_case(want, label, name, env["file_root"], "_test")
    assert m_got == m_want


def test_validate_draws_from_an_epoch_seeded_generator(env, tmp_path):
    """With neither a generator nor draws, validate seeds a generator
    from the epoch and draws from it case after case: the same as
    handing it that generator."""
    kw = dict(cube=CUBE, step=STEP, device="cpu")
    args = (env["port"], SEUNetConfig(), NAMES[:1], env["data_root"], env["file_root"], 5)
    with contextlib.redirect_stdout(io.StringIO()):
        a = peng.validate(*args, str(tmp_path / "a.txt"), **kw)
        b = peng.validate(*args, str(tmp_path / "b.txt"),
                          generator=torch.Generator().manual_seed(5), **kw)
    assert a == b
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
