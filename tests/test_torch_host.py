"""The port's copies of the host code (NIfTI codec, post-processing,
STL export, metrics, LOG book, split files, CT preprocessing) against
the JAX package's twins on the same inputs: numpy only, equal unless
stated. The post-processing runs on both routes, the native library and
the scipy fallbacks."""

import json
import os

import numpy as np
import pytest

import se_unet_airseg_tpu.post._native as jnative
import se_unet_airseg_tpu_torch.post._native as pnative
from se_unet_airseg_tpu import metrics as jmetrics
from se_unet_airseg_tpu.data import splits as jsplits
from se_unet_airseg_tpu.io import nifti as jnifti
from se_unet_airseg_tpu.pipeline import preprocess as jprep
from se_unet_airseg_tpu.post import mesh as jmesh
from se_unet_airseg_tpu.train import logbook as jlog
from se_unet_airseg_tpu_torch import metrics as pmetrics
from se_unet_airseg_tpu_torch.data import splits as psplits
from se_unet_airseg_tpu_torch.io import nifti as pnifti
from se_unet_airseg_tpu_torch.pipeline import preprocess as pprep
from se_unet_airseg_tpu_torch.post import mesh as pmesh
from se_unet_airseg_tpu_torch.train import logbook as plog

from test_cli_entrypoints import _raw_case

GOLD = os.path.join(os.path.dirname(__file__), "golden", "post_goldens.npz")
DIRECTION = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])


def _same_volume(a, b):
    np.testing.assert_array_equal(a.array, b.array)
    assert a.array.dtype == b.array.dtype
    assert a.spacing == b.spacing and a.origin == b.origin
    np.testing.assert_array_equal(a.direction, b.direction)


@pytest.mark.parametrize("code", sorted(pnifti._DTYPES))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_nifti_round_trip_across_packages(tmp_path, code, writer):
    assert pnifti._DTYPES == jnifti._DTYPES
    dtype = np.dtype(pnifti._DTYPES[code])
    r = np.random.default_rng(code)
    if dtype.kind == "f":
        arr = r.normal(0, 100, (7, 5, 6)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        arr = r.integers(max(info.min, -30000), min(info.max, 30000), (7, 5, 6)).astype(dtype)
    meta = ((0.7, 0.8, 2.5), (-12.5, 30.25, 101.0), DIRECTION)
    w, rd = (pnifti, jnifti) if writer == "port" else (jnifti, pnifti)
    path = str(tmp_path / "v.nii.gz")
    w.write_nifti(path, arr, *meta)
    got = rd.read_nifti(path)
    _same_volume(got, w.read_nifti(path))
    np.testing.assert_array_equal(got.array, arr)
    np.testing.assert_allclose(got.spacing, meta[0], rtol=1e-6)
    np.testing.assert_allclose(got.origin, meta[1], rtol=1e-6)
    np.testing.assert_allclose(got.direction, DIRECTION, atol=1e-6)
    # the two writers emit the same bytes
    other = str(tmp_path / "o.nii.gz")
    rd.write_nifti(other, arr, *meta)
    assert open(path, "rb").read() == open(other, "rb").read()


def _masks():
    """Planted masks: the goldens' inputs and seeded blobs with holes."""
    gold = np.load(GOLD)
    out = [gold[k] for k in ("cc0_in", "cc1_in", "fill0_in", "skel0_in")]
    r = np.random.default_rng(0)
    for shape in ((24, 20, 16), (9, 31, 12)):
        m = (r.random(shape) > 0.62).astype(np.uint8)
        m[3:8, 4:12, 4:10] = 1
        m[5, 7, 6] = 0  # a hole
        out.append(m)
    return out


@pytest.fixture(params=["native", "scipy"])
def route(request, monkeypatch):
    """Run the post functions of both packages on one route."""
    if request.param == "native":
        assert pnative.native_available() and jnative.native_available()
    else:
        monkeypatch.setattr(pnative, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    return request.param


@pytest.mark.parametrize("i", range(6))
def test_components_and_holes_match_jax(route, i):
    m = _masks()[i]
    for conn in (26, 6):
        lp, n_p = pnative.connected_components(m, conn)
        lj, n_j = jnative.connected_components(m, conn)
        assert n_p == n_j and lp.dtype == lj.dtype
        np.testing.assert_array_equal(lp, lj)
        np.testing.assert_array_equal(pnative.component_counts(lp, n_p),
                                      jnative.component_counts(lj, n_j))
        np.testing.assert_array_equal(pnative.largest_component(m, conn),
                                      jnative.largest_component(m, conn))
    np.testing.assert_array_equal(pnative.fill_holes(m), jnative.fill_holes(m))
    np.testing.assert_array_equal(pnative.fill_holes(m[2]), jnative.fill_holes(m[2]))
    np.testing.assert_array_equal(pprep.largest_cc_midslice_fallback(m),
                                  jprep.largest_cc_midslice_fallback(m))
    np.testing.assert_array_equal(pprep.largest_cc_midslice_fallback(m, probe_z=(0, 99)),
                                  jprep.largest_cc_midslice_fallback(m, probe_z=(0, 99)))
    np.testing.assert_array_equal(pprep.largest_cc_filled(m), jprep.largest_cc_filled(m))


@pytest.mark.parametrize("h,l", [(0.5, 0.4), (0.5, 0.35)])
def test_dti_matches_jax(route, h, l):
    r = np.random.default_rng(int(h * 100 + l * 100))
    # a smooth field, so the band grows from seeds over several voxels
    score = r.random((20, 18, 22)).astype(np.float32)
    score = (score + np.roll(score, 1, 0) + np.roll(score, 1, 1) + np.roll(score, 1, 2)) / 4
    got = pnative.dti(score, h, l)
    np.testing.assert_array_equal(got, jnative.dti(score, h, l))
    assert 0 < got.sum() < got.size
    np.testing.assert_array_equal(pnative._dti_python(score, h, l),
                                  jnative._dti_python(score, h, l))


def test_routes_agree(monkeypatch):
    """The native library and the scipy fallbacks give the same masks."""
    def outputs(m):
        score = m * np.float32(0.45) + np.float32(0.1) * (m[::-1] > 0)
        return pnative.largest_component(m), pnative.fill_holes(m), pnative.dti(score, 0.5, 0.4)

    lib = [outputs(m) for m in _masks()]
    monkeypatch.setattr(pnative, "_load", lambda: None)
    for want, m in zip(lib, _masks()):
        for a, b in zip(outputs(m), want):
            np.testing.assert_array_equal(a, b)


def test_skeleton_matches_jax(route):
    gold = np.load(GOLD)
    m = gold["skel0_in"]
    if route == "scipy":
        for fn in (pnative.skeletonize_3d, jnative.skeletonize_3d):
            with pytest.raises(RuntimeError, match="native library"):
                fn(m)
        return
    got = pnative.skeletonize_3d(m)
    np.testing.assert_array_equal(got, jnative.skeletonize_3d(m))
    np.testing.assert_array_equal(got, gold["skel0_out"])


def test_native_library_builds_from_the_root_source():
    lib = pnative._load()
    assert lib is not None
    assert pnative._SRC.name == "airseg_post.cpp" and pnative._SRC.parent.name == "csrc"
    path = pnative._build()
    assert path.parent == pnative._BUILD_DIR and path.exists()
    assert path.parent.parent.parent.name == "se_unet_airseg_tpu_torch"


def test_stl_bytes_match_jax(tmp_path):
    m = np.zeros((20, 24, 18), np.uint8)
    m[4:16, 10:14, 6:10] = 1
    m[8:11, 6:20, 7:9] = 1
    kw = dict(center=np.array([9.5, 11.0, 8.0]), scale=10.0, spacing=(0.8, 0.7, 1.25))
    n_p = pmesh.export_mask_stl(str(tmp_path / "p.stl"), m, **kw)
    n_j = jmesh.export_mask_stl(str(tmp_path / "j.stl"), m, **kw)
    assert n_p == n_j > 0
    assert (tmp_path / "p.stl").read_bytes() == (tmp_path / "j.stl").read_bytes()
    np.testing.assert_array_equal(pmesh.marching_surface(m.astype(np.float32)),
                                  jmesh.marching_surface(m.astype(np.float32)))


def _metric_case(seed: int):
    r = np.random.default_rng(seed)
    shape = (16, 20, 12)
    label = (r.random(shape) > 0.7).astype(np.uint8)
    pred = ((label + (r.random(shape) > 0.85)) % 2).astype(np.uint8)
    skel = (label * (r.random(shape) > 0.5)).astype(np.uint8)
    parse = r.integers(0, 9, shape).astype(np.int16) * (label > 0)
    return pred, label, parse, skel


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluation_suite_matches_jax(seed):
    args = _metric_case(seed)
    got, want = pmetrics.evaluation_suite(*args), jmetrics.evaluation_suite(*args)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    for fn in ("stage2_selection_score", "stage3_selection_score", "test_selection_score"):
        assert getattr(pmetrics, fn)(got) == pytest.approx(getattr(jmetrics, fn)(want),
                                                           abs=1e-12)


def test_logbook_text_and_picks_match_jax(tmp_path):
    cases = [[pmetrics.evaluation_suite(*_metric_case(10 * e + c)) for c in range(3)]
             for e in range(4)]
    for e, ms in enumerate(cases):
        assert plog.append_epoch(str(tmp_path / "p.txt"), e, ms) == \
            jlog.append_epoch(str(tmp_path / "j.txt"), e, ms)
    for suffix in ("", ".jsonl"):
        assert (tmp_path / f"p.txt{suffix}").read_text() == \
            (tmp_path / f"j.txt{suffix}").read_text()
    for fn in ("best_epoch_test", "best_epoch", "best_epoch_recall"):
        assert getattr(plog, fn)(str(tmp_path / "p.txt")) == \
            getattr(jlog, fn)(str(tmp_path / "j.txt"))


def test_split_files_match_jax(tmp_path):
    os.makedirs(tmp_path / "mask")
    for i in range(9):
        (tmp_path / "mask" / f"CASE{i:03d}mask_cut.nii.gz").write_bytes(b"")
    psplits.write_split_json(str(tmp_path / "mask"), str(tmp_path / "p"))
    jsplits.write_split_json(str(tmp_path / "mask"), str(tmp_path / "j"))
    for f in ("base_dict.json", "test.json"):
        assert (tmp_path / "p" / f).read_text() == (tmp_path / "j" / f).read_text()
    base = str(tmp_path / "p" / "base_dict.json")
    for mode in (("train",), ("train", "val")):
        assert psplits.load_json_file(base, "0", mode) == jsplits.load_json_file(base, "0", mode)
    with open(tmp_path / "t.json", "w") as f:
        json.dump({"test": ["CASE001mask_cut.nii.gz", "CASE002.nii.gz"]}, f)
    got = psplits.load_json_file(str(tmp_path / "t.json"), "-1")
    assert got == jsplits.load_json_file(str(tmp_path / "t.json"), "-1") == ["CASE001",
                                                                           "CASE002"]


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("mode", ["prepro", "prediction"])
def test_preprocess_matches_jax(tmp_path, mode):
    """Both modes write the same arrays, box and metadata; the mask cut
    (prepro) too."""
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    os.makedirs(raw)
    ct = str(raw / "CASE001data.nii.gz")
    jnifti.write_nifti(ct, _raw_case(rng).astype(np.int16), (0.7, 0.7, 1.5),
                       (-100.0, 20.0, 5.0))
    mask = np.zeros((96, 96, 48), np.uint8)
    mask[20:40, 20:26, 10:40] = 1
    mask[50:52, 50:52, 5:7] = 1  # a second, smaller component
    jnifti.write_nifti(str(raw / "CASE001mask.nii.gz"), mask, (0.7, 0.7, 1.5))
    for pkg, prep in (("p", pprep), ("j", jprep)):
        for sub in ("data", "mask"):
            os.makedirs(tmp_path / pkg / sub)
        assert prep.preprocess_ct_volume(ct, str(tmp_path / pkg / "data"), mode) == "CASE001"
        if mode == "prepro":
            prep.preprocess_mask_volume(str(raw / "CASE001mask.nii.gz"),
                                        str(tmp_path / pkg / "mask"))
    files = _tree(tmp_path / "p")
    assert files == _tree(tmp_path / "j")
    want = {"prepro": {"data/CASE001_box.npy", "data/CASE001_lung_mask.nii.gz",
                       "data/CASE001data_cut.nii.gz", "mask/CASE001mask_cut.nii.gz"},
            "prediction": {"data/CASE001data_cut.nii.gz"}}[mode]
    assert set(files) == want
    for f in files:
        a, b = str(tmp_path / "p" / f), str(tmp_path / "j" / f)
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            _same_volume(pnifti.read_nifti(a), jnifti.read_nifti(b))
