"""Prior/label engineering between curriculum stages (reference L2).

Generates every side-car artifact of the on-disk contract:

  * `save_lib_weights`    — LIB weight maps, float16
    (reference lib_weight.py:36-53; the 7^3 density filter runs on the
    device through `ops.lib_filter.lib_weight_map`).
  * `save_skeletons_and_parses` — GT skeletons + branch-id parse maps
    for train/val/test splits (reference ske_and_parse.py:67-189).
  * `save_stage_pred`     — binarized full-volume predictions of a
    stage checkpoint over train+val (pred_1: reference
    save_gradients.py:63-142; pred_2: weight_br.py:30-110). The
    reference thresholds RAW LOGITS at 0.5 without sigmoid and runs
    the net in train mode: both preserved. Saved with a leading 1-axis
    like the reference's nibabel writes (consumers index [0]).
  * `save_weight_break`   — break-point priors: FN skeleton, hard-
    mining weight, break-segment weight, break-skeleton coordinates
    (reference weight_br.py:113-177, reproduced operation by operation
    including the in-place `inds` reuse).

Counterpart of the JAX package's `pipeline/priors.py`. The port's
choices: the device work (`lib_weight_map`, the runner) runs on `device`
(default `cuda`, raising without CUDA; tests pass "cpu"); the JAX twin
draws each case's DropLayer uniforms from `fold_in(key(1), i)`, which
torch cannot reproduce, so `save_stage_pred` seeds one
`torch.Generator(device)` per case from (1, i), or takes the draws from
`drop_draws`, one list of per-tile-batch `[r_en, r_de]` per case, as
`infer/engine.py` does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.splits import load_json_file
from ..io import read_nifti, write_nifti
from ..ops.lib_filter import lib_weight_map
from ..post import (
    binary_dilation,
    box_convolve27,
    connected_components,
    edt_with_indices,
    fill_holes,
    largest_component,
    skeletonize_3d,
)
from ..post.topology import airway_parse
from ..utils.devices import resolve_device


def save_lib_weights(mask_dir: str, save_dir: str, device=None):
    os.makedirs(save_dir, exist_ok=True)
    for f in sorted(os.listdir(mask_dir)):
        if "mask" not in f:
            continue
        name = f.split("mask")[0]
        label = read_nifti(os.path.join(mask_dir, f)).array
        w = lib_weight_map((label > 0).astype(np.float32), device=device).cpu().numpy()
        np.save(os.path.join(save_dir, name + ".npy"), w.astype(np.float16))


def save_skeletons_and_parses(
    mask_dir: str,
    file_path: str,
    parse_dir: str,
    skel_dir: str,
    split: str = "train",
    merge_t: int = 5,
):
    """GT skeleton + tree-parse artifacts for one split (reference
    ske_and_parse.py:67-189; split names map to the reference's
    tree_parse[/(_val|_test)] directory convention at the call site)."""
    os.makedirs(parse_dir, exist_ok=True)
    os.makedirs(skel_dir, exist_ok=True)
    folder, mode = ("-1", ("test",)) if split == "test" else ("0", (split,))
    names = sorted(load_json_file(file_path, folder, mode))
    for name in names:
        f = name + "mask_cut.nii.gz"
        v = read_nifti(os.path.join(mask_dir, f))
        label = (v.array > 0).astype(np.uint8)
        label = largest_component(label)
        label = fill_holes(label)
        skel = skeletonize_3d(label)
        write_nifti(os.path.join(skel_dir, f), skel, v.spacing, v.origin)
        parse = airway_parse(label, merge_t=merge_t)
        write_nifti(os.path.join(parse_dir, f), parse, v.spacing, v.origin)


def save_stage_pred(
    params,
    cfg,
    file_path: str,
    data_root: str,
    save_dir: str,
    cube: int = 128,
    step: int = 64,
    *,
    device=None,
    drop_draws=None,
    mesh=None,
):
    """Full-volume binarized predictions over train+val for the next
    stage's hard-mining (raw-logit > 0.5, train-mode net — reference
    save_gradients.py:130-137 / weight_br.py:94-102). `drop_draws`, when
    given, holds one sequence of per-tile-batch draws per case (in the
    sorted order of the names). With a `mesh` (a `parallel.DataMesh`)
    each rank predicts and writes its share of the cases
    (`DataMesh.cases`), each case on the draws of one process."""
    from ..infer.sliding_window import SlidingWindowRunner

    dev = resolve_device(device, mesh)
    os.makedirs(save_dir, exist_ok=True)
    runner = SlidingWindowRunner(
        params, cfg, use_sigmoid=False, train_mode=True, cube=cube, step=step, device=dev
    )
    names = sorted(load_json_file(file_path, "0", ("train", "val")))
    for i in range(len(names)) if mesh is None else mesh.cases(len(names)):
        name = names[i]
        img = read_nifti(os.path.join(data_root, "data", name + "data_cut.nii.gz"))
        # seeded from (1, i), where the JAX twin folds i into key 1
        draws = ({"drop_draws": drop_draws[i]} if drop_draws is not None else
                 {"generator": torch.Generator(device=dev).manual_seed((1 << 32) + i)})
        trits = runner.predict_trits(img.array, h_thresh=0.5, l_thresh=0.5,
                                     hu_shift=-1024.0, **draws)
        pred = (trits == 2).astype(np.uint8)
        # leading 1-axis mirrors the reference's nibabel [1,D,H,W] files
        write_nifti(os.path.join(save_dir, name + ".nii.gz"), pred[None])


def save_weight_break(
    data_root: str,
    pred2_dir: str,
    br_weight_dir: str,
    br_skel_dir: str,
    file_path: str,
    mesh=None,
):
    """Break-point priors (reference weight_br.py:113-177). With a `mesh`
    each rank writes its share of the cases (`DataMesh.cases`)."""
    os.makedirs(br_weight_dir, exist_ok=True)
    os.makedirs(br_skel_dir, exist_ok=True)
    names = sorted(load_json_file(file_path, "0", ("train", "val")))
    if mesh is not None:
        names = [names[i] for i in mesh.cases(len(names))]
    for name in names:
        label = read_nifti(
            os.path.join(data_root, "mask", name + "mask_cut.nii.gz")
        ).array
        label = (label > 0).astype(np.uint8)
        pred = read_nifti(os.path.join(pred2_dir, name + ".nii.gz")).array
        if pred.ndim > 3:
            pred = pred[0]
        fn = ((label.astype(np.float32) - pred) > 0).astype(np.uint8)
        skeleton = skeletonize_3d(label)
        fn_skel = fn * skeleton

        # hard-mining weight: propagate skeleton-FN to the full label
        # via nearest-skeleton indices, radius-normalized
        edt, inds = edt_with_indices(1 - skeleton)
        hard_mining = fn_skel[inds[0], inds[1], inds[2]] * label
        loc = (hard_mining > 0).astype(np.uint8)
        f = loc * edt * (1.0 - skeleton)
        maxf = float(np.amax(f))
        if maxf == 0:
            w_br = np.zeros(label.shape, np.float16)
            np.save(os.path.join(br_weight_dir, name + ".npy"), w_br)
            np.save(
                os.path.join(br_skel_dir, name + ".npy"),
                np.where(np.zeros(label.shape) == 1),
            )
            continue
        D = -(f / maxf) + 1
        D = D * loc
        w_hm = (hard_mining.astype(np.float32) ** 2) * (D ** 2)

        # break segments: FN-skeleton components whose endpoints do not
        # touch the remaining skeleton (degree test via 3^3 convolution,
        # reference weight_br.py:153-163)
        cd, ncomp = connected_components(fn_skel.astype(np.uint8), 26)
        br_skel = np.zeros(cd.shape)
        conv_sk = box_convolve27(skeleton)
        for i in range(1, ncomp + 1):
            t = (cd == i).astype(np.int8)
            if np.sum((conv_sk * t) == 2):
                continue
            br_skel += t
        br_label = br_skel[inds[0], inds[1], inds[2]] * label
        shell = binary_dilation(br_label).astype(np.float32) - (
            br_label > 0
        ).astype(np.float32)
        edt2 = edt_with_indices(1 - shell, return_indices=False)
        w_br = br_label * edt2
        w_br[w_br >= 2] = 2
        lam = 0.7
        w_br = (w_br.astype(np.float32) + w_hm) * lam + 1 - lam
        w_br = w_br * hard_mining
        np.save(os.path.join(br_weight_dir, name + ".npy"), w_br.astype(np.float16))
        np.save(os.path.join(br_skel_dir, name + ".npy"), np.where(br_skel == 1))
