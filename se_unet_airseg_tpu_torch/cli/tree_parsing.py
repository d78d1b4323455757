"""Airway tree-parsing CLI — reference-compatible flags and reports.

Mirrors the reference's only argparse surface (reference
tree_parsing.py:213-262): `--pred_mask_path --save_path
--save_ATM22_path --merge_t`, iterating every mask in the input
directory. Per case it writes, into `--save_path` ("Ours" parser):

  <case>_parse.npy   object array of per-branch mm centerlines
  <case>_parse_map.nii.gz  voxel branch-id map (extra artifact)
  <case>_time.txt    "Centerline segment time %d seconds /
                      Airway tree parse time %d seconds /
                      Number of branches %d" (reference format,
                      tree_parsing.py:70-76)

and into `--save_ATM22_path` the ATM22 parse map, .stl surface,
.png centerline render, rotating .gif + _model.png parse renders, and
_time.txt (reference tree_parsing.py:80-210). The reference renders
with pyvista/VTK, which is not a dependency here: surfaces come from the
native marching-tetrahedra STL writer and renders from matplotlib 3-D
(same artifact set, headless; skipped with a note where matplotlib is
missing).

Host code, a copy of the JAX package's `cli/tree_parsing.py` over the
port's `post` and `io`:

    python -m se_unet_airseg_tpu_torch.cli.tree_parsing --pred_mask_path masks/ \
        --save_path ours/ --save_ATM22_path atm22/
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..io import read_nifti, write_nifti
from ..post.atm22 import atm22_parse
from ..post.topology import TopologyTree, detect_order


def load_like_reference(path: str):
    """reference util.py:11-22 axis heuristic: (z,y,x) volumes with
    y==x are rotated to (y,x,z)."""
    v = read_nifti(path)
    arr = v.array
    a, b, c = arr.shape
    if b == c:
        arr = arr.transpose(1, 2, 0)
    return arr, v.spacing


def ours_parse_case(pred: np.ndarray, spacing, merge_t: int, save_dir: str,
                    case: str):
    stem = case.split(".nii.gz")[0]
    t0 = time.time()
    order = detect_order(pred)
    tree = TopologyTree(pred, order, merge_t, remerge_l=["000"])
    tree.sub()
    tree.merge()
    tree.grade()
    tree.regrade()
    # the reference's remerge trigger flags (rb23/rb12) are initialized
    # but never set there, so this matches: remerge stays reachable via
    # the same condition (reference tree_parsing.py:49-51)
    if tree.flags.get("rb23") == 1 or tree.flags.get("rb12") == 1:
        tree.remerge()
        tree.regrade()
    centerline_time = time.time() - t0
    print("Centerline segment time %d seconds" % centerline_time)

    np.save(
        os.path.join(save_dir, stem + "_parse.npy"),
        tree.resize(*spacing[:3]),
        allow_pickle=True,
    )
    t0 = time.time()
    parse_map = tree.parse_map()
    tree_parse_time = time.time() - t0
    write_nifti(os.path.join(save_dir, stem + "_parse_map.nii.gz"), parse_map)
    # STL surface + centerline/parse renders (the reference's pyvista
    # outputs, emitted via marching tetrahedra + matplotlib here)
    try:
        from ..post.mesh import export_mask_stl
        from ..post.render import render_centerlines, render_parse_map

        export_mask_stl(
            os.path.join(save_dir, stem + ".stl"), tree.label,
            center=tree.origin, scale=10.0,
        )
        render_centerlines(
            tree.Bi, os.path.join(save_dir, stem + "_line.png"),
            title=f"{stem}: {tree.branch_count} branches",
        )
        render_parse_map(
            parse_map, os.path.join(save_dir, stem + "_parse.png"),
            gif_path=os.path.join(save_dir, stem + "_parse.gif"),
        )
    except Exception as e:  # rendering is best-effort
        print(f"render skipped: {type(e).__name__}: {e}")
    print("Airway tree parse time %d seconds" % tree_parse_time)
    print("Number of branches %d " % tree.branch_count)

    with open(os.path.join(save_dir, stem + "_time.txt"), "w") as f:
        f.write("Centerline segment time %d seconds\n" % centerline_time)
        f.write("Airway tree parse time %d seconds\n" % tree_parse_time)
        f.write("Number of branches %d\n" % tree.branch_count)
    return tree


def atm22_parse_case(
    pred: np.ndarray, save_dir: str, case: str, spacing=(1.0, 1.0, 1.0)
):
    """ATM22 driver with the reference's full artifact set
    (tree_parsing.py:80-210): .stl surface, .png centerline render,
    rotating .gif + _model.png parse renders, _parse_map.nii.gz,
    _time.txt with centerline/parse timing + branch count."""
    from ..post.atm22 import atm22_centerline, atm22_refine

    stem = case.split(".nii.gz")[0]
    sp = np.asarray(spacing[:3], np.float32)

    # centerline stage: CC -> STL -> skeleton -> branch cut (the STL
    # export sits inside the timed window like the reference's recons)
    t0 = time.time()
    label, sl, crop, parse_skel, cd, num0 = atm22_centerline(pred)
    try:
        from ..post.mesh import export_mask_stl

        export_mask_stl(
            os.path.join(save_dir, stem + ".stl"), label, spacing=sp
        )
    except Exception as e:
        print(f"stl skipped: {type(e).__name__}: {e}")
    centerline_time = time.time() - t0
    print("Centerline segment time %d seconds" % centerline_time)

    # branch centerline render (reference's pl.add_lines loop)
    try:
        from ..post.render import render_centerlines

        lo = np.array([s.start for s in sl], np.float32)
        branches = [
            (np.argwhere(cd == i) + lo) * sp for i in range(1, num0 + 1)
        ]
        render_centerlines(
            branches, os.path.join(save_dir, stem + ".png"),
            title=f"{stem}: {num0} centerline segments",
        )
    except Exception as e:
        print(f"render skipped: {type(e).__name__}: {e}")

    # parse stage
    t0 = time.time()
    parse, num = atm22_refine(label.shape, sl, crop, parse_skel, cd, num0)
    dt = time.time() - t0
    write_nifti(os.path.join(save_dir, stem + "_parse_map.nii.gz"), parse)
    try:
        from ..post.render import render_parse_map

        render_parse_map(
            parse, os.path.join(save_dir, stem + "_model.png"),
            gif_path=os.path.join(save_dir, stem + ".gif"),
        )
    except Exception as e:
        print(f"render skipped: {type(e).__name__}: {e}")
    print("Airway tree parse time %d seconds" % dt)
    print("Number of branches %d " % num)
    with open(os.path.join(save_dir, stem + "_time.txt"), "w") as f:
        f.write("Centerline segment time %d seconds\n" % centerline_time)
        f.write("Airway tree parse time %d seconds\n" % dt)
        f.write("Number of branches %d\n" % num)
    return parse, num


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Process airway segmentation and tree parsing."
    )
    parser.add_argument(
        "--pred_mask_path", type=str, default="./demo_mask/",
        help="Path to the directory containing predicted mask files.",
    )
    parser.add_argument(
        "--save_path", type=str, default=None,
        help="Directory where the Ours output will be saved.",
    )
    parser.add_argument(
        "--save_ATM22_path", type=str, default=None,
        help="Directory where the ATM22 output will be saved.",
    )
    parser.add_argument(
        "--merge_t", type=int, default=5,
        help="Threshold for merging branches during airway skeleton parsing.",
    )
    args = parser.parse_args(argv)

    for case in sorted(os.listdir(args.pred_mask_path)):
        pred, spacing = load_like_reference(
            os.path.join(args.pred_mask_path, case)
        )
        pred = (pred > 0).astype(np.uint8)
        if args.save_path is not None:
            os.makedirs(args.save_path, exist_ok=True)
            ours_parse_case(pred, spacing, args.merge_t, args.save_path, case)
        if args.save_ATM22_path is not None:
            os.makedirs(args.save_ATM22_path, exist_ok=True)
            atm22_parse_case(pred, args.save_ATM22_path, case, spacing)


if __name__ == "__main__":
    main()
