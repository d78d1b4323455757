"""ATM22-challenge airway parser (the reference's baseline parser).

Re-designed from reference atm22_skel_parse.py:70-260. Same pipeline:
largest 6-connected component -> skeletonize -> cut junction voxels
(3^3 neighbor-count > 3) -> drop <5-voxel fragments -> label branch
segments -> EDT nearest-branch voxel assignment -> iterative tree
refinement (fuse multi-parents, collapse single children) to fixpoint.

Performance re-design: the reference relabels the full 512^3 volume
once per merge (`tree_parsing[tree_parsing==j] = k`, the dominant cost
of its 322 s CASE073 run). Here every refinement round simulates all
merges on an id lookup table and applies them in ONE vectorized LUT
pass; per-branch bounding boxes come from a single
`ndimage.find_objects` scan instead of a full-volume equality test per
branch.

Host code, a copy of the JAX package's `post/atm22.py`.
"""

from __future__ import annotations

import numpy as np

from ._native import (
    binary_dilation,
    edt_with_indices,
    fill_holes,
    find_objects,
    skeletonize_3d,
)
from . import connected_components, component_counts


def _label26(vol: np.ndarray) -> tuple[np.ndarray, int]:
    """26-connectivity labeling (scipy ndimage.label with a full 3^3
    structure) via the native union-find labeler — same raster
    first-encounter label order, which the 298-branch CASE073 parity
    depends on."""
    labels, n = connected_components(vol, 26)
    return labels.astype(np.int32), n


def largest_component_6(mask: np.ndarray) -> np.ndarray:
    """Largest 6-connected component + fill holes (reference
    atm22_skel_parse.py:70-80).

    Runs on the foreground bounding box (margin 2): identical result —
    every component lives inside the bbox, and a hole is enclosed by
    foreground so the crop's zero border stays connected to the crop
    boundary — at a fraction of the 512^3 voxel traffic (CC 6 s -> ~1 s,
    fill_holes 11 s -> ~2 s on CASE073)."""
    idx = np.argwhere(mask)
    if idx.size == 0:
        return np.zeros(mask.shape, np.uint8)
    lo = np.maximum(idx.min(axis=0) - 2, 0)
    hi = np.minimum(idx.max(axis=0) + 3, mask.shape)
    sl = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
    crop = (mask[sl] > 0).astype(np.uint8)
    labels, n = connected_components(crop, 6)
    if n == 0:
        return np.zeros(mask.shape, np.uint8)
    counts = component_counts(labels, n)
    best = labels == int(np.argmax(counts)) + 1
    out = np.zeros(mask.shape, np.uint8)
    out[sl] = fill_holes(best)
    return out


def skeleton_parsing(skeleton: np.ndarray):
    """Cut junction voxels and label skeleton segments (reference
    atm22_skel_parse.py:83-101).

    The junction test (3^3 neighbor count > 3, center included) only
    matters AT skeleton voxels, so the count is gathered sparsely at
    the ~10^4 skeleton coordinates instead of convolving the dense
    volume (3.2 s -> ~0.1 s); small-fragment removal is one LUT gather
    instead of np.isin (3.9 s -> ~0.3 s). Label order (scipy raster
    order) is untouched — branch ids feed the refinement sequence the
    298-branch CASE073 parity depends on."""
    sk = (skeleton != 0)
    coords = np.argwhere(sk)
    # symmetric = scipy ndimage.convolve's default mode='reflect'
    # (reference atm22_skel_parse.py:88 relies on it at volume borders)
    pad = np.pad(sk, 1, mode='symmetric').astype(np.uint8)
    cz, cy, cx = coords[:, 0] + 1, coords[:, 1] + 1, coords[:, 2] + 1
    count = np.zeros(len(coords), np.int32)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                count += pad[cz + dz, cy + dy, cx + dx]
    parse = sk.astype(np.float32)
    junc = coords[count > 3]  # count includes the center (reference conv)
    parse[junc[:, 0], junc[:, 1], junc[:, 2]] = 0
    cd, num = _label26(parse)
    counts = np.bincount(cd.reshape(-1))
    small = counts[1:] < 5
    if small.any():
        keep = np.ones(num + 1, parse.dtype)
        keep[1:][small] = 0
        parse *= keep[cd]
    cd, num = _label26(parse)
    return parse.astype(np.uint8), cd, int(num)


def tree_parsing_func(skeleton_parse, label, cd):
    """Nearest-skeleton-segment voxel assignment (reference
    atm22_skel_parse.py:103-108)."""
    _, inds = edt_with_indices(1 - skeleton_parse.astype(np.uint8))
    return (cd[inds[0], inds[1], inds[2]] * label).astype(np.uint16)


def loc_trachea(parse: np.ndarray, num: int) -> int:
    counts = np.bincount(parse.reshape(-1), minlength=num + 1)[1:]
    return int(np.argmax(counts)) + 1


def adjacent_map(parse: np.ndarray, num: int) -> np.ndarray:
    """Branch adjacency via boundary dilation, one find_objects scan
    (reference atm22_skel_parse.py:120-135)."""
    ad = np.zeros((num, num), np.uint8)
    slices = find_objects(parse.astype(np.int32), max_label=num)
    for i, sl in enumerate(slices):
        if sl is None:
            continue
        # widen by 2 so the dilated boundary can see the neighbors
        sl = tuple(
            slice(max(s.start - 2, 0), min(s.stop + 2, d))
            for s, d in zip(sl, parse.shape)
        )
        local = parse[sl]
        cur = (local == i + 1).astype(np.uint8)
        boundary = binary_dilation(cur) - cur
        touch = np.unique(local[boundary.astype(bool)])
        for j in touch:
            if j > 0:
                ad[i, j - 1] = 1
    return ad


def parent_children_map(ad: np.ndarray, trachea: int, num: int):
    """Generation-ordered BFS from the trachea (reference
    atm22_skel_parse.py:137-165)."""
    parent = np.zeros((num, num), np.uint8)
    children = np.zeros((num, num), np.uint8)
    generation = np.zeros(num, np.int32)
    parent[trachea - 1, trachea - 1] = 1
    frontier = [trachea - 1]
    while frontier:
        nxt = []
        stack = list(frontier)
        while stack:
            cur = stack.pop()
            for child in np.where(ad[cur] > 0)[0]:
                if parent[child].sum() == 0:
                    parent[child, cur] = 1
                    children[cur, child] = 1
                    generation[child] = generation[cur] + 1
                    nxt.append(child)
                elif generation[cur] + 1 == generation[child]:
                    parent[child, cur] = 1
                    children[cur, child] = 1
        frontier = nxt
    return parent, children, generation


def _plan_refinement(parent: np.ndarray, children: np.ndarray, num: int):
    """Simulate the reference's in-place merge sequence on an id LUT
    (reference atm22_skel_parse.py:167-217). Returns (lut, delete_ids):
    lut maps current id -> merged id (1-based, 0 preserved)."""
    lut = np.arange(num + 1, dtype=np.int32)
    delete_ids: list[int] = []

    multi = np.where(parent.sum(axis=1) > 1)[0]
    for w in multi:
        ps = np.where(parent[w] > 0)[0]
        for j in ps[1:]:
            lut[lut == (j + 1)] = ps[0] + 1
            if j not in delete_ids:
                delete_ids.append(int(j))

    only_child_parents = np.where(children.sum(axis=1) == 1)[0]
    for cur in only_child_parents:
        if cur in delete_ids:
            continue
        child = int(np.where(children[cur] == 1)[0][0])
        if child in delete_ids:
            continue
        lut[lut == (child + 1)] = cur + 1
        delete_ids.append(child)

    if delete_ids:
        # compact the surviving ids (reference's final renumber loop)
        deleted = np.zeros(num + 1, bool)
        deleted[np.asarray(delete_ids) + 1] = True
        shift = np.cumsum(deleted)
        compact = np.arange(num + 1) - shift
        lut = compact[lut].astype(np.int32)
    return lut, delete_ids


def refine_to_fixpoint(parse: np.ndarray, num: int):
    """Iterate adjacency -> parent/children -> merge until stable
    (reference tree_parsing.py's whether_refinement loop)."""
    for _ in range(64):
        trachea = loc_trachea(parse, num)
        ad = adjacent_map(parse, num)
        parent, children, _ = parent_children_map(ad, trachea, num)
        lut, deleted = _plan_refinement(parent, children, num)
        if not deleted:
            break
        parse = lut[parse]
        num -= len(deleted)
    return parse.astype(np.uint16), num


def atm22_centerline(mask: np.ndarray):
    """Centerline stage (reference tree_parsing.py:96-118): largest
    6-CC -> skeletonize -> junction-cut branch labels, with the heavy
    voxel work bbox-cropped. Returns (label, sl, crop, parse_skel, cd,
    num) where `sl` places `crop` back into the full volume."""
    label = largest_component_6(mask)
    idx = np.argwhere(label)
    lo = np.maximum(idx.min(axis=0) - 4, 0)
    hi = np.minimum(idx.max(axis=0) + 5, label.shape)
    sl = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
    crop = label[sl]
    skel = skeletonize_3d(crop)
    parse_skel, cd, num = skeleton_parsing(skel)
    return label, sl, crop, parse_skel, cd, num


def atm22_refine(label_shape, sl, crop, parse_skel, cd, num):
    """Parse stage (reference tree_parsing.py:146-160):
    nearest-skeleton voxel assignment + refinement fixpoint. Returns
    (full-volume parse map uint16, n_branches)."""
    parse = tree_parsing_func(parse_skel, crop, cd)
    parse, num = refine_to_fixpoint(parse, num)
    out = np.zeros(label_shape, np.uint16)
    out[sl] = parse
    return out, num


def atm22_parse(mask: np.ndarray):
    """Full ATM22 pipeline for one binary airway mask. Returns
    (parse_map uint16, n_branches)."""
    label, sl, crop, parse_skel, cd, num = atm22_centerline(mask)
    return atm22_refine(label.shape, sl, crop, parse_skel, cd, num)
