"""Airway-tree topology: skeleton -> branches -> hierarchy -> parse map.

Re-designed from the behavior of the reference's "Ours" parser
(reference ours_skel_parse.py:30-164 subsection, 388-481 merging,
621-646 grade, 515-520 tree_parsing_func; ske_and_parse.py:20-65
airway_parse; tree_parsing.py:23-38 order detection). The reference
walks a dict-backed sparse volume in pure Python; this implementation
keeps the same observable branch decomposition while using set-based
adjacency — the input skeletons are ~10^3-10^4 points, so the walk is
host-side Python and the heavy voxel work (skeletonization, EDT
nearest-branch assignment, connected components) lives in the native
library.

Semantics preserved:
  * traversal starts at the minimum-z skeleton point (first occurrence
    in z-sorted order, ours_skel_parse.py:53-54);
  * a voxel with >= 3 skeleton neighbors (26-adjacency) ends the
    current branch ('end') and spawns one child branch per unvisited
    neighbor, all recording the junction branch as father;
  * `merging`: (a) branches with <= merge_t points are deleted — leaf
    twigs vanish, short internal branches are absorbed into every
    child; (b) single-child chains collapse into the parent;
  * `grade`: hierarchical string codes, root '0', the two main bronchi
    ordered by start-y ('00' = smaller y), then first-come suffixes;
  * `tree_parsing_func`: every foreground voxel takes the branch id of
    the nearest rasterized skeleton point (exact EDT with indices).

The trachea-centerline smoothing pass (ours_skel_parse.py:247-386) is
implemented below (`smooth_main_airway` + the re-subsection in
`Topology_Tree.sub`), and the anatomical `regrade` relabeling
(653-978) lives in `post/regrade.py`.

Host code, a copy of the JAX package's `post/topology.py` (its twin on
the same inputs gives the same branches, codes and maps).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from itertools import product

import numpy as np

from ._native import (
    binary_closing,
    binary_dilation,
    connected_components,
    edt_with_indices,
    fill_holes,
    skeletonize_3d,
)
from . import largest_component

_NB26 = [
    (dz, dy, dx)
    for dz, dy, dx in product((-1, 0, 1), repeat=3)
    if (dz, dy, dx) != (0, 0, 0)
]
# the reference's 26-neighbor enumeration order (ours_skel_parse.py:
# 46-52: the 8 same-z offsets, then the 9 at z-1, then the 9 at z+1).
# Queue order decides which points join which branch at junctions, so
# branch decomposition parity requires this exact order.
_NB26_REF = [
    (-1, -1, 0), (-1, 0, 0), (-1, 1, 0), (0, -1, 0), (0, 1, 0),
    (1, -1, 0), (1, 0, 0), (1, 1, 0), (-1, -1, -1), (-1, 0, -1),
    (-1, 1, -1), (0, -1, -1), (0, 0, -1), (0, 1, -1), (1, -1, -1),
    (1, 0, -1), (1, 1, -1), (-1, -1, 1), (-1, 0, 1), (-1, 1, 1),
    (0, -1, 1), (0, 0, 1), (0, 1, 1), (1, -1, 1), (1, 0, 1), (1, 1, 1),
]


@dataclasses.dataclass
class Branch:
    index: int  # 1-based creation order
    start: tuple[int, int, int]
    member: list[tuple[int, int, int]]
    father: int  # parent branch index, 0 for the root
    end: tuple[int, int, int] | None = None

    def points(self) -> list[tuple[int, int, int]]:
        pts = [self.start, *self.member]
        if self.end is not None:
            pts.append(self.end)
        return pts

    def __len__(self) -> int:
        return len(self.points())


def subsection(points: np.ndarray) -> list[Branch]:
    """Split a skeleton point cloud into branches at junction voxels.

    Faithful reimplementation of the reference walk (reference
    ours_skel_parse.py:30-164, called with debug=1) — branch membership
    AND creation indices must match because merging's length threshold
    and grade's anatomical codes consume them:

      * seeds at the FIRST minimum-z row of `points` (callers pass the
        z-argsorted cloud, so row order is the reference's);
      * neighbors enumerate in the `_NB26_REF` order;
      * a point with >= 3 skeleton neighbors (visited or not) ends the
        branch; its unvisited neighbors become new start nodes;
      * when a start node has several unvisited neighbors, neighbors
        1.. walk first (each sibling's member list ACCUMULATES onto the
        previous sibling's — reference behavior), neighbor 0 walks last
        with a fresh member list (the debug=1 reset), and the index
        counter follows the reference's quirky arithmetic (4+ siblings
        skip an index);
      * queue entries are not deduplicated: a point reachable from two
        predecessors is processed twice and lands in `member` twice —
        branch "length" counts these duplicates, as in the reference.
    """
    pts = set(map(tuple, points.tolist()))
    zmin = points[:, 2].min()
    seed_row = int(np.nonzero(points[:, 2] == zmin)[0][0])
    seed = tuple(points[seed_row].tolist())

    visited = {seed}
    startnode: deque = deque([(seed, 0)])
    branches: list[Branch] = []
    branchn = 0

    def walk_branch(first, member, index):
        """Walk one branch from `first`; mutates `member` in place and
        marks visits. Returns (end, extends) where extends are the
        junction's unvisited neighbors (already marked visited)."""
        queue: deque = deque([first])
        while queue:
            cur = queue[0]
            count = 0
            fresh = []
            for d in _NB26_REF:
                nb = (cur[0] + d[0], cur[1] + d[1], cur[2] + d[2])
                if nb in pts:
                    count += 1
                    if nb not in visited:
                        queue.append(nb)
                        fresh.append(nb)
            visited.add(cur)
            if count < 3:
                member.append(cur)
            else:
                for nb in fresh:
                    visited.add(nb)
                    startnode.append((nb, index))
                return cur
            queue.popleft()
        return None

    while startnode:
        start, father = startnode[0]
        branchn += 1
        linkstack = [
            (start[0] + d[0], start[1] + d[1], start[2] + d[2])
            for d in _NB26_REF
            if (start[0] + d[0], start[1] + d[1], start[2] + d[2]) in pts
            and (start[0] + d[0], start[1] + d[1], start[2] + d[2])
            not in visited
        ]
        member: list = []
        if len(linkstack) > 1:
            for l in range(1, len(linkstack)):
                branchn = branchn + l - 1
                br = Branch(branchn, start, [], father)
                end = walk_branch(linkstack[l], member, branchn)
                br.member = list(member)
                br.end = end
                branches.append(br)
            branchn += 1
            member = []  # the reference's debug=1 reset
        br = Branch(branchn, start, [], father)
        end = walk_branch(linkstack[0], member, branchn) if linkstack else None
        br.member = list(member)
        br.end = end
        branches.append(br)
        startnode.popleft()
    return branches


def merging(branches: list[Branch], len_thre: int) -> list[Branch]:
    """Two-phase branch cleanup (reference ours_skel_parse.py:388-481)."""
    # phase 1: absorb/delete short branches
    cut: set[int] = set()
    for i, b in enumerate(branches):
        if len(b) > len_thre:
            continue
        sons = [c for c in branches[i + 1 :] if c.father == b.index]
        for child in sons:
            child.father = b.father
            glue = list(b.member)
            if b.end is not None:
                glue.append(b.end)
            glue.append(child.start)
            child.member = glue + child.member
            child.start = b.start
        cut.add(i)
    branches = [b for i, b in enumerate(branches) if i not in cut]

    # phase 2: collapse single-child chains (reference
    # ours_skel_parse.py:444-481). Two reference behaviors matter for
    # branch-count parity and are kept exactly:
    #   * singles are processed in REVERSED order, so a chain
    #     A -> B -> C collapses fully into A (C glues into B first,
    #     then B-with-C glues into A);
    #   * the first entry of np.where(child_num == 1) is dropped
    #     unconditionally — usually the virtual father 0, but when the
    #     root was absorbed in phase 1 it silently drops a real single.
    if not branches:
        return branches
    child_num = np.zeros(branches[-1].index, dtype=int)
    for b in branches:
        if b.father < len(child_num):
            child_num[b.father] += 1
    single = list(np.where(child_num == 1)[0])[1:]
    single_pos = [
        i for s in single for i, b in enumerate(branches) if b.index == s
    ]
    cut_pos: set[int] = set()
    remap: list[tuple[int, int]] = []  # (parent_index, child_index)
    for s in reversed(range(len(single_pos))):
        parent = branches[single_pos[s]]
        for i in reversed(range(len(branches))):
            child = branches[i]
            if child.father != parent.index:
                continue
            remap.append((parent.index, child.index))
            cut_pos.add(i)
            glue = [parent.end] if parent.end is not None else []
            glue.append(child.start)
            glue.extend(child.member)
            if child.end is not None:
                parent.end = child.end
            else:
                parent.end = glue[-1]
                glue = glue[:-1]
            parent.member = parent.member + glue
    # reparent grandchildren in the same (reversed-single) order the
    # reference's second loop runs, so chains re-route transitively
    for parent_idx, child_idx in remap:
        for b in branches:
            if b.father == child_idx:
                b.father = parent_idx
    return [b for i, b in enumerate(branches) if i not in cut_pos]


def grade(branches: list[Branch]) -> list[dict]:
    """Hierarchical string codes (reference ours_skel_parse.py:621-646).

    Returns [{'code', 'father_code'}] aligned with `branches`.
    """
    n = len(branches)
    codes = [None] * n
    fcodes = [None] * n
    if n == 0:
        return []
    codes[0], fcodes[0] = "0", "-1"
    if n >= 3:
        if branches[1].start[1] > branches[2].start[1]:
            codes[1], codes[2] = "01", "00"
        else:
            codes[1], codes[2] = "00", "01"
        fcodes[1] = fcodes[2] = "0"
    elif n == 2:
        codes[1], fcodes[1] = "00", "0"
    flag = [0] * n
    by_index = {b.index: g for g, b in enumerate(branches)}
    for i in range(3, n):
        g = by_index.get(branches[i].father)
        if g is None or codes[g] is None:
            codes[i], fcodes[i] = "?", "?"
            continue
        codes[i] = codes[g] + str(flag[g])
        fcodes[i] = codes[g]
        flag[g] += 1
    return [{"code": c, "father_code": f} for c, f in zip(codes, fcodes)]


def rasterize_branches(branches: list[Branch], shape) -> np.ndarray:
    """Branch-id map over skeleton voxels (first branch wins ties),
    ids = position+1 (reference ske_and_parse.py:48-59)."""
    cd = np.zeros(shape, np.int32)
    for i, b in enumerate(branches, start=1):
        for p in b.points():
            if cd[p] == 0:
                cd[p] = i
    return cd


def tree_parsing_func(skeleton_parse: np.ndarray, label: np.ndarray,
                      cd: np.ndarray) -> np.ndarray:
    """Assign every labeled voxel the id of its nearest skeleton point
    (reference ours_skel_parse.py:515-520)."""
    _, inds = edt_with_indices(1 - skeleton_parse.astype(np.uint8))
    out = cd[inds[0], inds[1], inds[2]] * label
    return out.astype(np.uint16)


def compute_base_vector(vol: np.ndarray, order: int) -> np.ndarray:
    """Direction of the main airway from two axial slice centroids
    (reference ours_skel_parse.py:166-196)."""
    zs = np.where(vol.any(axis=(0, 1)))[0]
    minz, maxz = int(zs.min()), int(zs.max())
    cha = maxz - minz
    if order == 1:
        z1, z2 = int(maxz - 0.1 * cha), int(0.6 * cha + minz)
    else:
        z1, z2 = int(minz + 0.1 * cha), int(0.4 * cha + minz)
    c1 = np.argwhere(vol[:, :, z1] > 0).mean(axis=0)
    c2 = np.argwhere(vol[:, :, z2] > 0).mean(axis=0)
    if order == 1:
        return np.array([c2[0] - c1[0], c2[1] - c1[1], z1 - z2], np.float64)
    return np.array([c2[0] - c1[0], c2[1] - c1[1], z2 - z1], np.float64)


def _cosine(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def find_mainpart_index(max_seed_z: float, branches: list[Branch],
                        basev: np.ndarray) -> int:
    """Walk the first branches and find where the main airway ends —
    the first long branch whose direction falls off the trachea axis
    (cosine thresholds from reference ours_skel_parse.py:205-245)."""
    mainpart = []
    for i, b in enumerate(branches):
        if i > 20:
            break
        if len(b.member) == 0:
            continue
        if len(b.member) > max_seed_z / 3.6:
            break
        v = np.asarray(b.member[-1], np.float64) - np.asarray(b.start, np.float64)
        if len(b.member) > 12:
            mainpart.append((i, _cosine(basev, v)))
    flag = False
    for i, cos in mainpart:
        if cos < 0.928 and not flag:
            continue
        if cos > 0.928:
            flag = True
        if cos < 0.93 and flag:
            return i
    return 0


def smooth_points(pts: np.ndarray) -> np.ndarray:
    """Resample the main-airway centerline through 4 control points,
    clamp steps to +/-1 voxel, dedup by z and enforce continuity
    (reference ours_skel_parse.py:247-330)."""
    from scipy.interpolate import interp1d

    n = len(pts)
    idx = np.arange(0, n, max(n // 3, 1))
    idx = np.append(idx, [n - 1])
    if abs(idx[-2] - idx[-1]) < 5:
        idx = np.delete(idx, -2)
    sel = pts[idx].astype(np.float64)
    t = np.linspace(0, n - 1, n)
    interp = np.stack(
        [interp1d(idx, sel[:, k], kind="linear", fill_value="extrapolate")(t)
         for k in range(3)],
        axis=1,
    )
    # clamp consecutive steps to +/-1
    out = np.zeros_like(interp, dtype=int)
    out[0] = np.round(interp[0]).astype(int)
    for i in range(1, n):
        cur = np.round(interp[i]).astype(int)
        for k in range(3):
            if abs(cur[k] - out[i - 1][k]) > 1:
                cur[k] = out[i - 1][k] + np.sign(cur[k] - out[i - 1][k])
        out[i] = cur
    # default (unstable) argsort: the tie order feeds the keep-first-
    # per-z dedup below, exactly as in the reference (ours_skel_parse.py:294)
    out = out[np.argsort(out[:, 2])]
    # dedup by z (keep first per z), reverse, re-enforce continuity
    uniq, last_z = [], None
    for pt in out:
        if pt[2] != last_z:
            uniq.append(pt)
            last_z = pt[2]
    uniq = list(reversed(uniq))
    final = [uniq[0]]
    for pt in uniq[1:]:
        cur = pt.copy()
        prev = final[-1]
        for k in range(3):
            if abs(cur[k] - prev[k]) > 1:
                cur[k] = prev[k] + np.sign(cur[k] - prev[k])
        final.append(cur)
    return np.flip(np.asarray(final), axis=0)


def replace_mainairway(B: np.ndarray, branches: list[Branch], mmm: int) -> np.ndarray:
    """Substitute the first `mmm` branches' points with the smoothed
    centerline inside the full skeleton point cloud (reference
    ours_skel_parse.py:333-386). Returns the new point cloud, to be
    re-subsectioned."""
    main = []
    for i, b in enumerate(branches):
        if i >= mmm:
            break
        main.append(b.start)
        main += b.member
        if b.end is not None:
            main.append(b.end)
    main = np.unique(np.asarray(main), axis=0)

    # order the main points by their (reversed) position in B
    index_map = {tuple(row): i for i, row in enumerate(B[::-1].tolist())}
    main = np.asarray(
        sorted(main.tolist(), key=lambda r: index_map.get(tuple(r), 0))
    )
    new_main = smooth_points(main)

    # drop the main points beyond the smoothed length, replace the rest
    cut = main[: len(main) - len(new_main)]
    cut_set = set(map(tuple, cut.tolist()))
    keep = np.asarray([r for r in B.tolist() if tuple(r) not in cut_set])
    main_tail = main[len(main) - len(new_main):]
    tail_set = {tuple(r): k for k, r in enumerate(main_tail.tolist())}
    out = keep.copy()
    replaced = {}
    for i, row in enumerate(keep.tolist()):
        k = tail_set.get(tuple(row))
        if k is not None and k not in replaced:
            out[i] = new_main[k]
            replaced[k] = True
    return out


def detect_order(mask: np.ndarray) -> int:
    """Trachea orientation: compare largest 2-D component areas at 20%
    vs 80% of the z-span (reference tree_parsing.py:23-38)."""
    zs = np.where(mask.any(axis=(0, 1)))[0]
    minz, maxz = int(zs.min()), int(zs.max())
    cha = maxz - minz

    def largest2d(z):
        # 8-conn 2-D labeling == 26-conn 3-D on a depth-1 volume
        lab, nl = connected_components(mask[:, :, z][None], 26)
        if nl == 0:
            return 0
        c = np.bincount(lab.reshape(-1))
        c[0] = 0
        return int(c.max())

    return 0 if largest2d(int(0.2 * cha + minz)) > largest2d(int(0.8 * cha + minz)) else 1


class TopologyTree:
    """Orchestrates skeleton -> branch -> hierarchy for one airway mask
    (reference ours_skel_parse.py:522-1021, rendering omitted)."""

    def __init__(self, label: np.ndarray, order: int, merge_t: int,
                 remerge_l=()):
        self.label = (label > 0).astype(np.uint8)
        self.order = order
        self.merge_t = merge_t
        self.remerge_l = list(remerge_l)
        self.B: np.ndarray | None = None
        self.Bi: list[Branch] = []
        self.Bi_g: list[dict] = []
        self.origin = None

    def _bbox(self, margin: int = 4):
        idx = np.argwhere(self.label)
        lo = np.maximum(idx.min(axis=0) - margin, 0)
        hi = np.minimum(idx.max(axis=0) + margin + 1, self.label.shape)
        return tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))

    def sub(self):
        """Fill/dilate/close -> largest CC -> skeletonize -> subsection
        (reference ours_skel_parse.py:569-600; the trachea-centerline
        smoothing pass is not yet reproduced).

        The morphology/thinning run on the airway's bounding box (the
        mask occupies a fraction of the 512^3 volume) — identical
        result, far less voxel traffic than the reference's full-volume
        passes."""
        from ..pipeline.preprocess import largest_cc_midslice_fallback

        sl = self._bbox()
        crop = self.label[sl]
        vol = fill_holes(binary_dilation(crop))
        vol = binary_closing(vol)
        # maximum_3d semantics: largest CC with 2nd-largest mid-slice
        # fallback + fill holes (reference sub() calls maximum_3d,
        # ours_skel_parse.py:580 -> util.py:58-75). The reference
        # probes FULL-volume slices z//2, z//3, z//3*2 — map them into
        # crop coordinates (out-of-crop probes are automatic misses)
        zf = self.label.shape[2]
        z0 = sl[2].start
        vol = largest_cc_midslice_fallback(
            vol.astype(np.uint8),
            probe_z=(zf // 2 - z0, zf // 3 - z0, zf // 3 * 2 - z0),
        )
        skel_c = skeletonize_3d(vol)
        skel = np.zeros(self.label.shape, np.uint8)
        skel[sl] = skel_c
        B = np.argwhere(skel != 0)
        # UNSTABLE argsort like the reference (ours_skel_parse.py:582):
        # the tie order among equal-z rows decides the walk seed and the
        # branch decomposition, so the sort kind is part of the contract
        B = B[B[:, 2].argsort()]
        self.origin = B.mean(axis=0)
        if self.order == 1:
            # flip z so the walk seeds at the trachea; row order stays
            # original-z ascending, exactly like the reference
            B = B.copy()
            B[:, 2] = self.label.shape[2] - B[:, 2]
        self.B = B
        self.Bi = subsection(B)
        # trachea-centerline smoothing: rewrite the main-airway points
        # and re-subsection (reference ours_skel_parse.py:590-597)
        basev = compute_base_vector(vol, self.order)
        mmm = find_mainpart_index(float(B[0, 2]), self.Bi, basev)
        if mmm > 1:
            B = replace_mainairway(B, self.Bi, mmm)
            self.B = B
            self.Bi = subsection(B)

    def merge(self):
        self.Bi = merging(self.Bi, self.merge_t)
        if self.order == 1:
            z = self.label.shape[2]
            for b in self.Bi:
                b.start = (b.start[0], b.start[1], z - b.start[2])
                if b.end is not None:
                    b.end = (b.end[0], b.end[1], z - b.end[2])
                b.member = [(p[0], p[1], z - p[2]) for p in b.member]

    def grade(self):
        self.Bi_g = grade(self.Bi)

    def regrade(self):
        """Anatomical relabeling of the hierarchical codes (reference
        ours_skel_parse.py:653-978); sets the rb*/lb*/l010 missing-
        branch flags the CLI consults for conditional remerge."""
        from .regrade import AnatomicalRegrader

        codes = [
            {"code": g["code"], "father_code": g["father_code"]}
            for g in self.Bi_g
        ]
        self.Bi_g, self.flags = AnatomicalRegrader(self.Bi, codes, self.order).run()

    def remerge(self):
        """Targeted re-merge of the shortest child under each code in
        remerge_l (reference ours_skel_parse.py:483-513, 648-651),
        then re-grade."""
        by_code = {g["code"]: i for i, g in enumerate(self.Bi_g)}
        cut: set[int] = set()
        for code in self.remerge_l:
            kids = [
                i for i, g in enumerate(self.Bi_g) if g["father_code"] == code
            ]
            if not kids or len(kids) > 3:
                continue
            shortest = min(kids, key=lambda i: len(self.Bi[i]))
            b = self.Bi[shortest]
            for child in self.Bi:
                if child.father == b.index:
                    child.father = b.father
                    glue = list(b.member)
                    if b.end is not None:
                        glue.append(b.end)
                    glue.append(child.start)
                    child.member = glue + child.member
                    child.start = b.start
            cut.add(shortest)
        self.Bi = [b for i, b in enumerate(self.Bi) if i not in cut]
        del by_code
        self.grade()

    def parse_map(self) -> np.ndarray:
        # EDT runs on the bounding box only — nearest-skeleton
        # assignment is local to the airway
        sl = self._bbox()
        cd = rasterize_branches(self.Bi, self.label.shape)[sl]
        skel = (cd != 0).astype(np.uint8)
        out = np.zeros(self.label.shape, np.uint16)
        out[sl] = tree_parsing_func(skel, self.label[sl], cd)
        return out

    def resize(self, px: float, py: float, pz: float) -> np.ndarray:
        """Branch centerlines in physical mm, origin-centered
        (reference ours_skel_parse.py:980-1021). Returns an object
        array of per-branch (N,3) float arrays."""
        out = []
        o = self.origin if self.origin is not None else np.zeros(3)
        for b in self.Bi:
            pts = np.asarray(b.points(), np.float64)
            out.append((pts - o) * np.array([px, py, pz]))
        return np.array(out, dtype=object)

    @property
    def branch_count(self) -> int:
        return len(self.Bi)


def airway_parse(mask: np.ndarray, merge_t: int = 5) -> np.ndarray:
    """Training-prior parse map for one binary airway mask
    (reference ske_and_parse.py:20-65)."""
    order = detect_order(mask)
    tree = TopologyTree(mask, order, merge_t, remerge_l=["000"])
    tree.sub()
    tree.merge()
    tree.grade()
    return tree.parse_map()
