"""The port's tree parsers and the native functions under them against
the JAX package's twins, on the same inputs; everything must match
exactly (branch lists, codes, flags, parse maps, counts and arrays).

Inputs: JAX's own Y-tree (tests/test_cli.py::_y_tree_mask), the regrade
tree (tests/test_regrade.py::_tree), and a tube tree drawn from a numpy
seed (also flipped along z, which turns the trachea's order). The five
native functions are held on both routes, the native library and the
scipy fallbacks, against scipy itself and against the twin."""

import copy
import dataclasses
import os

import numpy as np
import pytest
from scipy import ndimage

import se_unet_airseg_tpu.post._native as jnative
import se_unet_airseg_tpu_torch.post._native as pnative
from se_unet_airseg_tpu.post import atm22 as jatm, regrade as jreg, topology as jtopo
from se_unet_airseg_tpu_torch.post import atm22 as patm, regrade as preg, render as prender
from se_unet_airseg_tpu_torch.post import topology as ptopo

from test_cli import _y_tree_mask
from test_regrade import _tree as regrade_tree


def tube_tree(seed: int, shape=(64, 64, 80)) -> np.ndarray:
    """A trachea along axis 2 and two generations of branches at seeded
    angles, each a 3x3-voxel tube (odd width: a stable skeleton)."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, np.uint8)
    hi = np.array(shape) - 3

    def segment(p0, p1):
        n = int(np.ceil(np.linalg.norm(p1 - p0) * 2)) + 1
        for t in np.linspace(0, 1, n):
            y, x, z = np.clip(np.round(p0 + t * (p1 - p0)).astype(int), 2, hi)
            m[y - 1:y + 2, x - 1:x + 2, z - 1:z + 2] = 1

    top = np.array([shape[0] / 2, shape[1] / 2, 4.0])
    split = top + [0, 0, 26]
    segment(top, split)
    for side in (-1, 1):
        d1 = np.array([side * rng.uniform(0.5, 1.0), rng.uniform(-0.4, 0.4), rng.uniform(0.3, 0.8)])
        p1 = split + d1 / np.linalg.norm(d1) * rng.uniform(14, 20)
        segment(split, p1)
        for turn in (-1, 1):
            d2 = d1 + [0, turn * rng.uniform(0.4, 0.9), rng.uniform(0.2, 0.6)]
            segment(p1, p1 + d2 / np.linalg.norm(d2) * rng.uniform(8, 12))
    return m


CASES = {"y_tree": lambda: _y_tree_mask(),
         "tube": lambda: tube_tree(3),
         "tube_flipped": lambda: tube_tree(3)[:, :, ::-1].copy()}
ORDER = {"y_tree": 1, "tube": 1, "tube_flipped": 0}


@pytest.fixture(params=["native", "scipy"])
def route(request, monkeypatch):
    """Run the native functions of both packages on one route."""
    if request.param == "native":
        assert pnative.native_available() and jnative.native_available()
    else:
        monkeypatch.setattr(pnative, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    return request.param


def _blobs(seed: int, shape=(20, 18, 22)) -> np.ndarray:
    r = np.random.default_rng(seed)
    return (ndimage.uniform_filter(r.random(shape), 3) > 0.55).astype(np.uint8)


@pytest.mark.parametrize("seed", range(3))
def test_native_functions_match_scipy_and_jax(route, seed):
    m = _blobs(seed)
    assert 0 < m.sum() < m.size
    for fn, ref in ((pnative.binary_dilation, ndimage.binary_dilation),
                    (pnative.binary_closing, ndimage.binary_closing)):
        got = fn(m)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref(m).astype(np.uint8))
        np.testing.assert_array_equal(got, getattr(jnative, fn.__name__)(m))

    # the 3^3 sum: exact on small integers (the priors' 0/1 skeletons)
    ints = np.random.default_rng(seed).integers(0, 4, m.shape).astype(np.float32)
    got = pnative.box_convolve27(ints)
    np.testing.assert_array_equal(got, ndimage.convolve(ints, np.ones((3, 3, 3), np.float32)))
    floats = np.random.default_rng(seed).random(m.shape).astype(np.float32)
    np.testing.assert_array_equal(pnative.box_convolve27(floats), jnative.box_convolve27(floats))

    labels, n = ndimage.label(m)
    labels[labels == 2] = 0  # a label that never occurs
    got = pnative.find_objects(labels, n + 1)
    assert got == ndimage.find_objects(labels.astype(np.int32), max_label=n + 1)
    assert got == jnative.find_objects(labels, n + 1) and got[1] is None and got[-1] is None

    dist, idx = pnative.edt_with_indices(m)
    want_d, want_i = ndimage.distance_transform_edt(m, return_indices=True)
    assert dist.dtype == np.float32 and idx.dtype == np.int32
    np.testing.assert_array_equal(dist, want_d.astype(np.float32))
    if route == "scipy":
        np.testing.assert_array_equal(idx, want_i)
    else:
        # the native library breaks ties between equidistant zeros in
        # its own order: each index is a zero at the voxel's distance
        assert not m[tuple(idx)].any()
        grid = np.indices(m.shape)
        np.testing.assert_array_equal(((idx - grid) ** 2).sum(0), (want_d ** 2).round())
    jd, ji = jnative.edt_with_indices(m)
    np.testing.assert_array_equal(dist, jd)
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_array_equal(pnative.edt_with_indices(m, return_indices=False), dist)


def _branches(bs):
    return [(b.index, tuple(b.start), [tuple(p) for p in b.member], b.father,
             None if b.end is None else tuple(b.end)) for b in bs]


def _to_port(bs):
    return [ptopo.Branch(**dataclasses.asdict(b)) for b in bs]


@pytest.mark.parametrize("case", list(CASES))
def test_topology_tree_matches_jax(case):
    mask = CASES[case]()
    order = ptopo.detect_order(mask)
    assert order == jtopo.detect_order(mask)
    assert order == ORDER[case]  # both orientations are covered
    p, j = (mod.TopologyTree(mask, order, 5, remerge_l=["000"]) for mod in (ptopo, jtopo))
    p.sub()
    j.sub()
    np.testing.assert_array_equal(p.B, j.B)
    np.testing.assert_array_equal(p.origin, j.origin)
    assert _branches(p.Bi) == _branches(j.Bi)
    # the stages one at a time, on the same skeleton point cloud
    sub_p, sub_j = ptopo.subsection(p.B), jtopo.subsection(j.B)
    assert _branches(sub_p) == _branches(sub_j)
    merged = ptopo.merging(copy.deepcopy(sub_p), 5)
    assert _branches(merged) == _branches(jtopo.merging(copy.deepcopy(sub_j), 5))
    assert ptopo.grade(merged) == jtopo.grade(jtopo.merging(copy.deepcopy(sub_j), 5))

    for tree in (p, j):
        tree.merge()
        tree.grade()
    assert _branches(p.Bi) == _branches(j.Bi) and p.Bi_g == j.Bi_g
    assert p.branch_count >= 3
    for tree in (p, j):
        tree.regrade()
    assert p.Bi_g == j.Bi_g and p.flags == j.flags
    pm = p.parse_map()
    np.testing.assert_array_equal(pm, j.parse_map())
    assert pm.dtype == np.uint16 and (pm > 0).sum() == mask.sum()
    rp, rj = p.resize(0.7, 0.8, 1.25), j.resize(0.7, 0.8, 1.25)
    assert rp.dtype == rj.dtype == object and len(rp) == len(rj) == p.branch_count
    for a, b in zip(rp, rj):
        np.testing.assert_array_equal(a, b)
    for tree in (p, j):
        tree.remerge()
    assert _branches(p.Bi) == _branches(j.Bi) and p.Bi_g == j.Bi_g


@pytest.mark.parametrize("case", list(CASES))
def test_airway_parse_and_atm22_match_jax(case):
    mask = CASES[case]()
    got = ptopo.airway_parse(mask, merge_t=5)
    np.testing.assert_array_equal(got, jtopo.airway_parse(mask, merge_t=5))
    assert (got > 0).sum() == mask.sum()
    parse, n = patm.atm22_parse(mask)
    want, wn = jatm.atm22_parse(mask)
    assert n == wn and n >= 3
    np.testing.assert_array_equal(parse, want)


@pytest.mark.parametrize("order", [0, 1])
def test_regrader_matches_jax(order):
    j = regrade_tree(order)
    codes = jtopo.grade(j)
    want = jreg.AnatomicalRegrader(j, copy.deepcopy(codes), order).run()
    got = preg.AnatomicalRegrader(_to_port(regrade_tree(order)), copy.deepcopy(codes),
                                  order).run()
    assert got == want
    # tests/test_regrade.py's swapped main bronchi, which the regrade repairs
    swapped = copy.deepcopy(codes)
    swapped[1]["code"], swapped[2]["code"] = "01", "00"
    for c, f in zip(swapped[3:7], ("01", "01", "00", "00")):
        c["father_code"] = f
    for c, code in zip(swapped[3:7], ("010", "011", "000", "001")):
        c["code"] = code
    got = preg.AnatomicalRegrader(_to_port(j), copy.deepcopy(swapped), order).run()
    assert got == jreg.AnatomicalRegrader(j, copy.deepcopy(swapped), order).run()
    assert got[0][1]["code"].startswith("00") and got[0][2]["code"].startswith("01")


def test_render_writes_the_figures(tmp_path):
    mask = _y_tree_mask()
    tree = ptopo.TopologyTree(mask, 0, 5)
    tree.sub()
    tree.merge()
    prender.render_centerlines(tree.Bi, str(tmp_path / "line.png"))
    prender.render_parse_map(tree.parse_map(), str(tmp_path / "parse.png"),
                             gif_path=str(tmp_path / "parse.gif"))
    for f in ("line.png", "parse.png", "parse.gif"):
        assert os.path.getsize(tmp_path / f) > 0, f
