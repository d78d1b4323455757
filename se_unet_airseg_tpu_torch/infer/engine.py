"""Validation / test / deployment drivers over the sliding-window core.

Mirrors the reference's three inference consumers:

  * `validate`  — reference train.py:631-738: per val volume, overlap-
    averaged decoder-head sigmoid, binarize@0.5 or DTI(0.5,0.4),
    random/hard val Dice vs the stage-1 prediction (curriculum
    feedback), ATM22 metric block, LOG emission. Runs the net in
    TRAIN mode (DropLayer active) exactly like the reference does
    (train.py:632 — behavior, not a bug to fix silently).
  * `run_test`  — reference test.py:67-234: DTI(0.5,0.35), 15% x/y
    border suppression, largest 26-CC, nii.gz output with source
    geometry, aggregate metric line (+ boxplot when matplotlib
    exists).
  * `network_prediction` — reference prediction.py:51-154: deployment
    path, EVAL mode, DTI(0.5,0.4), border suppression, largest CC,
    `*_pred_mask.nii.gz` plus the skeleton-centered STL export.

All volume math (windowing, tiling, forward, overlap average,
double-threshold coding) runs on the device; the host copies the block
summary and the mixed blocks' payload (SlidingWindowRunner docstring).
`validate` and `run_test` keep one case in flight: case i+1 is queued on
the device before case i's host post-processing runs.

DropLayer draws in train mode: `generator` (a `torch.Generator` on the
runner's device) is drawn from case after case, tile batch after tile
batch; `drop_draws`, when given, holds one sequence per case, each with
one `[r_en, r_de]` per tile batch.

`validate(mesh=...)` splits the cases over the ranks of a
`parallel.DataMesh` (`DataMesh.cases`). A rank advances the generator
past the other ranks' cases (`SlidingWindowRunner.skip_draws`), so each
case sees the draws of one process; the per-case metrics are summed over
the ranks, rank 0 writes the LOG, and every rank returns the same means.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io import nifti_shape, read_nifti, write_nifti
from ..metrics import evaluation_suite
from ..models.se_unet import SEUNetConfig
from ..pipeline.preprocess import largest_cc_midslice_fallback as maximum_3d
from ..pipeline.preprocess import preprocess_ct_volume
from ..post import dti as dti_fn, largest_component
from ..parallel.mesh import sum_over_ranks
from ..train.logbook import _KEYS, append_epoch
from .sliding_window import SlidingWindowRunner, fetch_trits, trits_to_scores


def _load_case(data_root: str, name: str):
    img = read_nifti(os.path.join(data_root, "data", name + "data_cut.nii.gz"))
    label = read_nifti(os.path.join(data_root, "mask", name + "mask_cut.nii.gz"))
    return img, label.array.astype(np.uint8)


def _dispatch_binarize(runner, stored, dti_on: bool, h: float, l: float,
                       generator=None, drop_draws=None):
    """Queue a case's trit field on the device WITHOUT fetching. `stored` is
    the on-disk int16 HU+1024 volume; the -1024 shift happens on device."""
    ph, pl = (h, l) if dti_on else (0.5, 0.5)
    out = runner.predict_trits_summary_device(
        stored, h_thresh=ph, l_thresh=pl, hu_shift=-1024.0,
        generator=generator, drop_draws=drop_draws,
    )
    return (dti_on, h, l, out)


def _finish_binarize(handle) -> np.ndarray:
    """Fetch + decode + threshold/DTI the host side of a
    `_dispatch_binarize` handle."""
    dti_on, h, l, out = handle
    trits = fetch_trits(out)
    if dti_on:
        return dti_fn(trits_to_scores(trits, h, l), h, l)
    return (trits == 2).astype(np.uint8)


def evaluation_case(pred, label, name, file_root, suffix=""):
    """Largest-CC + ATM22 metric block vs the stored priors
    (reference train.py:740-775, test.py:236-270)."""
    parsing = read_nifti(
        os.path.join(file_root, "tree_parse" + suffix, name + "mask_cut.nii.gz")
    ).array
    skeleton = read_nifti(
        os.path.join(file_root, "skeleton" + suffix, name + "mask_cut.nii.gz")
    ).array
    skeleton = (skeleton > 0).astype(np.uint8)
    big = largest_component(pred.astype(np.uint8))
    if big.sum() == 0:
        big = pred.astype(np.uint8)
    m = evaluation_suite(big, label, parsing, skeleton)
    print(
        name,
        "TD: %0.4f" % m["TD"], "BD: %0.4f" % m["BD"], "DSC: %0.4f" % m["DSC"],
        "Precision: %0.4f" % m["Pre"], "Sen: %0.4f" % m["Sen"],
        "Spe: %0.4f" % m["Spe"],
    )
    return m


def _case_draws(drop_draws, i: int):
    return None if drop_draws is None else drop_draws[i]


def validate(
    params,
    cfg: SEUNetConfig,
    names: list[str],
    data_root: str,
    file_root: str,
    epoch: int,
    log_savepath: str,
    dti: bool = False,
    stage: int = 1,
    generator: torch.Generator | None = None,
    cube: int = 128,
    step: int = 64,
    runner: SlidingWindowRunner | None = None,
    *,
    drop_draws=None,
    device=None,
    mesh=None,
):
    """Returns (TD_mean, BD_mean, val_loss_random, val_loss_hard) —
    the curriculum scheduler's inputs (reference train.py:631-738).

    Pass a `runner` (reused across epochs via `set_params`) to keep its
    fast-path weights and count volumes between epochs. With a `mesh`
    every rank calls this with its own runner and takes its share of the
    cases (module docstring).
    """
    if runner is None:
        runner = SlidingWindowRunner(params, cfg, train_mode=True, cube=cube, step=step,
                                     device=device)
    else:
        runner.set_params(params)
    if generator is None and drop_draws is None:
        # train-mode validation draws FRESH DropLayer noise each epoch,
        # like the reference's per-call torch RNG (train.py:632): seed
        # from the epoch so best-epoch selection ranks under independent,
        # not correlated, dropout realizations
        generator = torch.Generator(device=runner.device).manual_seed(epoch)
    # a row a case: the metric block, then the random and hard val Dice
    rows = np.zeros((len(names), len(_KEYS) + 2))

    def finish(i, name, label, handle):
        pred = _finish_binarize(handle)
        if stage != 1:
            p1 = read_nifti(os.path.join(file_root, "pred_1", name + ".nii.gz")).array
            if p1.ndim > 3:
                p1 = p1[0]
            inv = 1 - p1
            hp, hl = pred * inv, label * inv
            rows[i, -2:] = (2 * (pred * label).sum() / max((pred + label).sum(), 1),
                            2 * (hp * hl).sum() / max((hp + hl).sum(), 1))
        m = evaluation_case(pred, label, name, file_root, "_val")
        rows[i, :len(_KEYS)] = [m[k] for k in _KEYS]

    mine = range(len(names)) if mesh is None else mesh.cases(len(names))
    # dispatch-ahead depth 1: case i's host post-processing (codec
    # decode, DTI, CC, metric suite) runs while case i+1 computes on
    # the device
    pending = None
    for i, name in enumerate(names):
        if i not in mine:
            if drop_draws is None:
                runner.skip_draws(
                    nifti_shape(os.path.join(data_root, "data", name + "data_cut.nii.gz")),
                    generator)
            continue
        img, label = _load_case(data_root, name)
        handle = _dispatch_binarize(runner, img.array, dti, 0.5, 0.4, generator=generator,
                                    drop_draws=_case_draws(drop_draws, i))
        if pending is not None:
            finish(*pending)
        pending = (i, name, label, handle)
    if pending is not None:
        finish(*pending)
    if mesh is not None:
        rows = sum_over_ranks(rows, mesh)
    metrics = [{k: float(v) for k, v in zip(_KEYS, r)} for r in rows]
    if mesh is None or mesh.is_main:
        print(append_epoch(log_savepath, epoch, metrics))
    rand_dice, hard_dice = ([], []) if stage == 1 else (list(rows[:, -2]), list(rows[:, -1]))
    td = float(np.mean([m["TD"] for m in metrics]))
    bd = float(np.mean([m["BD"] for m in metrics]))
    vr = float(np.mean(rand_dice)) if rand_dice else 0.0
    vh = float(np.mean(hard_dice)) if hard_dice else 0.0
    return td, bd, vr, vh


def border_suppress(pred: np.ndarray, frac: float = 0.15) -> np.ndarray:
    """Zero the first/last `frac` of the first two axes
    (reference test.py:117-120)."""
    out = pred.copy()
    out[: int(frac * out.shape[0])] = 0
    out[int((1 - frac) * out.shape[0]) :] = 0
    out[:, : int(frac * out.shape[1])] = 0
    out[:, int((1 - frac) * out.shape[1]) :] = 0
    return out


def run_test(
    params,
    cfg: SEUNetConfig,
    names: list[str],
    data_root: str,
    file_root: str,
    testlog_savepath: str,
    result_savepath: str,
    stage_name: str = "stage_three",
    dti: bool = True,
    generator: torch.Generator | None = None,
    cube: int = 128,
    step: int = 64,
    *,
    drop_draws=None,
    device=None,
):
    """Reference test.py flow; returns the per-case metric list."""
    runner = SlidingWindowRunner(params, cfg, train_mode=True, cube=cube, step=step,
                                 device=device)
    if generator is None and drop_draws is None:
        generator = torch.Generator(device=runner.device).manual_seed(0)
    outdir = os.path.join(result_savepath, stage_name)
    os.makedirs(outdir, exist_ok=True)
    metrics = []

    # maximum_3d = largest CC with 2nd-largest mid-slice fallback +
    # fill-holes (reference util.py:58-75, used at test.py:165-176)
    def finish(name, img, label, handle):
        pred = _finish_binarize(handle)
        pred = border_suppress(pred)
        pred = maximum_3d(pred)
        write_nifti(
            os.path.join(outdir, name + ".nii.gz"),
            pred.astype(np.int8), img.spacing, img.origin, img.direction,
        )
        metrics.append(evaluation_case(pred, label, name, file_root, "_test"))

    # dispatch-ahead depth 1 (see validate): host post of case i
    # overlaps case i+1's device compute
    pending = None
    for i, name in enumerate(names):
        img, label = _load_case(data_root, name)
        handle = _dispatch_binarize(runner, img.array, dti, 0.5, 0.35, generator=generator,
                                    drop_draws=_case_draws(drop_draws, i))
        if pending is not None:
            finish(*pending)
        pending = (name, img, label, handle)
    if pending is not None:
        finish(*pending)

    keys = ("TD", "BD", "DSC", "Pre", "Sen", "Spe")
    stats = []
    for k in keys:
        arr = np.array([m[k] for m in metrics])
        stats += [arr.mean(), arr.std()]
    line = (
        "TD: %0.4f (%0.4f), BD: %0.4f (%0.4f), DSC: %0.4f (%0.4f), "
        "Pre: %0.4f (%0.4f), Sen: %0.4f (%0.4f), Spe: %0.4f (%0.4f)" % tuple(stats)
    )
    print(line)
    with open(testlog_savepath, "a") as f:
        f.write(line + "\n")
    _maybe_boxplot(metrics, stage_name)
    return metrics


def _maybe_boxplot(metrics, stage_name):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    keys = ("TD", "BD", "DSC", "Pre", "Sen", "Spe")
    data = [[m[k] for m in metrics] for k in keys]
    plt.figure(figsize=(10, 10))
    plt.boxplot(data, meanline=True, showmeans=True, patch_artist=True)
    plt.xticks(range(1, len(keys) + 1), keys)
    plt.grid(linestyle="-.")
    plt.title("Metrics of " + stage_name, fontsize=25)
    plt.ylim(0, 105)
    plt.savefig("Metrics of " + stage_name + ".png")
    plt.close()


def network_prediction(
    params,
    cfg: SEUNetConfig,
    ct_path: str,
    save_dir: str,
    *,
    h_thresh: float = 0.5,
    l_thresh: float = 0.4,
    cube: int = 128,
    step: int = 64,
    device=None,
):
    """Deployment path (reference prediction.py:51-154): raw-HU volume
    in, `<case>_pred_mask.nii.gz` out. Runs in EVAL mode — the one
    inference consumer the reference runs under model.eval()
    (prediction.py:64)."""
    os.makedirs(save_dir, exist_ok=True)
    name = preprocess_ct_volume(ct_path, save_dir, mode="prediction")
    img = read_nifti(os.path.join(save_dir, name + "data_cut.nii.gz"))

    runner = SlidingWindowRunner(params, cfg, train_mode=False, cube=cube, step=step,
                                 device=device)
    trits = runner.predict_trits(
        img.array, h_thresh=h_thresh, l_thresh=l_thresh, hu_shift=-1024.0
    )
    pred = dti_fn(trits_to_scores(trits, h_thresh, l_thresh), h_thresh, l_thresh)
    pred = border_suppress(pred)
    # maximum_3d, not bare largest-CC (reference prediction.py:117)
    pred = maximum_3d(pred)
    out_path = os.path.join(save_dir, name + "_pred_mask.nii.gz")
    write_nifti(out_path, pred, img.spacing, img.origin, img.direction)

    # STL export, skeleton-centered and /10 scaled like the reference
    # (prediction.py:126-145); marching tetrahedra instead of skimage
    try:
        from ..post import skeletonize_3d
        from ..post.mesh import export_mask_stl

        if pred.sum() > 0:
            skel = skeletonize_3d(pred)
            coords = np.argwhere(skel > 0)
            center = coords.mean(axis=0) if len(coords) else np.zeros(3)
            export_mask_stl(
                os.path.join(save_dir, name + "_seg.stl"),
                pred, center=center, scale=10.0,
            )
    except RuntimeError:
        pass  # native lib unavailable: mask output only
    return out_path
