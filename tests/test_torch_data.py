"""The port's training host code against the JAX package's, on the CPU:
crop augmentations and samplers, the three stage datasets over whole
epochs, the online hard-mining cache and its replay order, the
curriculum schedulers, the TensorBoard writer's bytes (all exactly
equal), the LIB weight map (within 1e-6 of JAX, equal after the float16
store), the reader of the JAX package's `.msgpack` parameter files
(bit-exact), the full-state checkpoint and the `Prefetcher`, which
raises its thread's exception where the JAX one ends the epoch early.

`make_env` builds the 40^3 tube cases of `tests/test_resume.py::tiny_env`
(more of them) with the JAX package's prior writers and engineered
stage-3 break priors; `tests/test_torch_stages.py` drives the stage
drivers on it.
"""

import dataclasses
import json
import os
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from se_unet_airseg_tpu.data import augment as jaug
from se_unet_airseg_tpu.data import datasets as jds
from se_unet_airseg_tpu.data import samplers as jsmp
from se_unet_airseg_tpu.io import read_nifti, write_nifti
from se_unet_airseg_tpu.models.se_unet import SEUNetConfig as JaxConfig
from se_unet_airseg_tpu.models.se_unet import init_params
from se_unet_airseg_tpu.ops import lib_weight_map as jax_lib_weight_map
from se_unet_airseg_tpu.train import checkpoint as jckpt
from se_unet_airseg_tpu.train import online_cache as jcache
from se_unet_airseg_tpu.train import schedule as jsched
from se_unet_airseg_tpu.train import tensorboard as jtb
from se_unet_airseg_tpu_torch.data import augment as paug
from se_unet_airseg_tpu_torch.data import datasets as pds
from se_unet_airseg_tpu_torch.data import samplers as psmp
from se_unet_airseg_tpu_torch.models import SEUNet, SEUNetConfig
from se_unet_airseg_tpu_torch.models.torch_import import (
    params_from_state_dict,
    state_dict_from_jax_params,
)
from se_unet_airseg_tpu_torch.ops.lib_filter import lib_weight_map
from se_unet_airseg_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from se_unet_airseg_tpu_torch.train import checkpoint as pckpt
from se_unet_airseg_tpu_torch.train import online_cache as pcache
from se_unet_airseg_tpu_torch.train import schedule as psched
from se_unet_airseg_tpu_torch.train import tensorboard as ptb

from test_torch_sliding_window import torch_threads  # noqa: F401

SIDE = 40
GAP = slice(26, 30)  # the axial gap cut through the main tube for stage 3


def tube_case(rng):
    """A 40^3 CT (HU) and mask of tests/test_resume.py::tiny_env: an
    odd-width tube along the last axis with a side branch."""
    hu = rng.normal(30, 10, (SIDE,) * 3).astype(np.float32)
    mask = np.zeros((SIDE,) * 3, np.uint8)
    mask[18:21, 18:21, 4:36] = 1
    mask[18:21, 21:32, 18:21] = 1
    hu[mask == 1] = -950
    return hu, mask


def make_env(root, n_train: int, n_val: int = 1) -> dict:
    """AFTER_DATA cases and every prior the three stages read, written by
    the JAX package's prior writers (LIB weights, skeletons and parses)
    and directly (pred_1: the upper half of the airway; pred_2: the
    airway with an axial gap; br_skel: the skeleton in the gap; BR_weight:
    the airway around the gap)."""
    from se_unet_airseg_tpu.pipeline.priors import (
        save_lib_weights,
        save_skeletons_and_parses,
    )

    data_dir, mask_dir = root / "AFTER_DATA" / "data", root / "AFTER_DATA" / "mask"
    file_root = root / "data"
    for d in (data_dir, mask_dir, file_root / "pred_1", file_root / "pred_2",
              file_root / "br_skel", file_root / "BR_weight"):
        os.makedirs(d)
    rng = np.random.default_rng(0)
    names = [f"CASE{i:03d}" for i in range(n_train + n_val)]
    for n in names:
        hu, mask = tube_case(rng)
        write_nifti(str(data_dir / f"{n}data_cut.nii.gz"), (hu + 1024).astype(np.int16))
        write_nifti(str(mask_dir / f"{n}mask_cut.nii.gz"), mask)
        write_nifti(str(file_root / "pred_1" / f"{n}.nii.gz"),
                    (mask * (np.arange(SIDE) < SIDE // 2)[None, None, :]).astype(np.uint8))
        broken = mask.copy()
        broken[:, :, GAP] = 0
        write_nifti(str(file_root / "pred_2" / f"{n}.nii.gz"), broken[None])
    split = {"0": {"train": names[:n_train], "val": names[n_train:]}}
    with open(file_root / "base_dict.json", "w") as f:
        json.dump(split, f)
    save_lib_weights(str(mask_dir), str(file_root / "LIB_weight"))
    for s, suffix in (("train", ""), ("val", "_val")):
        save_skeletons_and_parses(str(mask_dir), str(file_root / "base_dict.json"),
                                  str(file_root / f"tree_parse{suffix}"),
                                  str(file_root / f"skeleton{suffix}"), split=s)
    for n in names[:n_train]:
        skel = read_nifti(str(file_root / "skeleton" / f"{n}mask_cut.nii.gz")).array > 0
        mask = read_nifti(str(mask_dir / f"{n}mask_cut.nii.gz")).array
        in_gap = np.zeros_like(skel)
        in_gap[:, :, GAP] = skel[:, :, GAP]
        np.save(file_root / "br_skel" / f"{n}.npy", np.array(np.where(in_gap)))
        near = np.zeros(mask.shape, np.float16)
        near[:, :, GAP.start - 2:GAP.stop + 2] = mask[:, :, GAP.start - 2:GAP.stop + 2]
        np.save(file_root / "BR_weight" / f"{n}.npy", near)
    return {"root": root, "data_root": str(root / "AFTER_DATA"), "file_root": str(file_root),
            "file_path": str(file_root / "base_dict.json"), "names": names,
            "train": names[:n_train], "val": names[n_train:]}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_env(tmp_path_factory.mktemp("data"), n_train=2)


def _same(a, b):
    """Equal nested results of numpy arrays, dicts, lists and scalars."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _both(fn_j, fn_p, seed: int, *args):
    """fn(*args, rng) of both packages from one seed: equal results and
    the Generators left in the same state."""
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    out_j, out_p = fn_j(*args, rj), fn_p(*args, rp)
    _same(out_p, out_j)
    assert rp.bit_generator.state == rj.bit_generator.state
    return out_p


def _vols(seed=0, shape=(40, 44, 48)):
    r = np.random.default_rng(seed)
    return {"hu": r.normal(size=shape).astype(np.float32),
            "label": (r.random(shape) > 0.8).astype(np.uint8),
            "lib": r.random(shape).astype(np.float16)}


@pytest.mark.parametrize("seed", range(12))
def test_augment_matches_jax(seed):
    arrays = list(_vols(seed, (12, 12, 12)).values())
    _both(jaug.augment_crops, paug.augment_crops, seed, arrays)
    _both(jaug.random_flip, paug.random_flip, seed, arrays)
    _both(jaug.random_rotate, paug.random_rotate, seed, arrays)
    _both(jaug.random_color, paug.random_color, seed, arrays[0])


@pytest.mark.parametrize("seed", range(6))
def test_samplers_match_jax(seed):
    vols = _vols(seed)
    label = vols["label"]
    skel = (np.random.default_rng(seed + 100).random(label.shape) > 0.95).astype(np.uint8)
    loc = np.where(skel != 0)
    empty = (np.array([], int),) * 3
    for cube in (16, 24):
        _both(jsmp.random_crop, psmp.random_crop, seed, vols, cube)
        _both(jsmp.centered_random_crop, psmp.centered_random_crop, seed, vols, cube)
        _both(jsmp.location_crop, psmp.location_crop, seed, vols, loc, cube)
        _both(jsmp.point_crop, psmp.point_crop, seed, vols, (39, 0, 20), cube)
        for small in (loc, empty):
            for skel_loc in (loc, empty):
                _both(jsmp.hard_sample, psmp.hard_sample, seed, vols, skel_loc, small, cube)

        def hard_lazy(pkg):
            def run(rng):
                sampler = pkg.small_airway_sampler(label, skel, rng)
                return [pkg.hard_sample(vols, loc, sampler, cube, rng) for _ in range(4)]
            return run

        _both(hard_lazy(jsmp), hard_lazy(psmp), seed)

    def points(pkg):
        def run(rng):
            draw = pkg.small_airway_sampler(label, skel, rng, max_tries=3)
            return [draw() for _ in range(20)]
        return run

    _both(points(jsmp), points(psmp), seed)


def _epochs(pkg, kind: str, env, n_epochs=2, **ratios):
    fr = env["file_root"]
    args = {"Stage1Crops": (), "Stage2Crops": (os.path.join(fr, "pred_1"),),
            "Stage3Crops": (os.path.join(fr, "pred_2"), os.path.join(fr, "br_skel"),
                            os.path.join(fr, "BR_weight"))}[kind]
    ds = getattr(pkg, kind)(env["file_path"], env["data_root"], fr, *args, batch_size=3,
                            cube=16, seed=11)
    for k, v in ratios.items():
        setattr(ds, k, v)
    assert len(ds) == len(env["train"])
    return [list(ds) for _ in range(n_epochs)]


@pytest.mark.parametrize("kind, ratios", [
    ("Stage1Crops", {}),
    ("Stage2Crops", {}),
    ("Stage2Crops", {"hard_ratio": 0.9}),
    ("Stage3Crops", {}),
    ("Stage3Crops", {"hard_ratio": 0.9, "break_ratio": 0.3}),
])
def test_stage_datasets_match_jax(env, kind, ratios):
    got = _epochs(pds, kind, env, **ratios)
    _same(got, _epochs(jds, kind, env, **ratios))
    batch = got[0][0]
    # stage 1's LIB weight rides along as `weight` too
    assert set(batch) == {"image", "label", "weight", "name"} | (
        {"skel"} if kind == "Stage3Crops" else set())
    assert batch["image"].shape == (3, 16, 16, 16, 2) and batch["image"].dtype == np.float32


def _fill(pkg, root: str, with_skel: bool):
    """One epoch of add_batch calls with scripted losses into a cache."""
    r = np.random.default_rng(1)
    cache = pkg.OnlineCache(root, with_skel=with_skel)
    cache.reset()
    for it in range(6):
        batch = {"image": r.random((2, 4, 4, 4, 2)).astype(np.float32),
                 "label": (r.random((2, 4, 4, 4)) > 0.5).astype(np.float32),
                 "weight": r.random((2, 4, 4, 4)).astype(np.float32),
                 "skel": (r.random((2, 4, 4, 4)) > 0.5).astype(np.float32)}
        cache.add_batch(batch, r.random(2).astype(np.float32), it, limit=5)
    return cache


def _tree_bytes(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.mark.parametrize("with_skel", [False, True])
def test_online_cache_and_replay_order_match_jax(tmp_path, with_skel):
    _fill(jcache, str(tmp_path / "jax"), with_skel)
    cache = _fill(pcache, str(tmp_path / "port"), with_skel)
    got, want = _tree_bytes(str(tmp_path / "port")), _tree_bytes(str(tmp_path / "jax"))
    assert got == want and len(got) == 5 * (4 if with_skel else 3)
    assert cache._names == sorted(cache._names, key=lambda n: float(n.split("_")[0]))
    for rate in (1.0, 0.5):
        replay = [
            list(pkg.OnlineCrops(str(tmp_path / sub), rate=rate, with_skel=with_skel,
                                 shuffle_rng=np.random.default_rng(9)))
            for pkg, sub in ((pds, "port"), (jds, "jax"))]
        _same(replay[0], replay[1])
        assert len(replay[0]) == int(rate * 5)


@pytest.mark.parametrize("seed", range(4))
def test_schedulers_match_jax(seed):
    r = np.random.default_rng(seed)
    for cls in ("CurriculumScheduler", "Stage3Scheduler"):
        sj, sp = getattr(jsched, cls)(), getattr(psched, cls)()
        hist = {"tr": [], "th": [], "td": [], "bd": []}
        for ep in range(30):
            for k in hist:
                hist[k].append(float(r.random() * (100 if k in ("td", "bd") else 0.2)))
            want = sj.update(ep, hist["tr"], hist["th"], hist["td"], hist["bd"])
            got = sp.update(ep, hist["tr"], hist["th"], hist["td"], hist["bd"])
            assert got == want and dataclasses.asdict(sp) == dataclasses.asdict(sj)
    assert psched.multistep_lr(1e-4, (40, 60), 0.1, 81) == jsched.multistep_lr(
        1e-4, (40, 60), 0.1, 81)


def test_tensorboard_bytes_match_jax(tmp_path, monkeypatch):
    out = {}
    for name, pkg in (("jax", jtb), ("port", ptb)):
        clock = iter(np.arange(1000.0, 1100.0, 0.25).tolist())
        monkeypatch.setattr(pkg, "time", SimpleNamespace(time=lambda: next(clock)))
        monkeypatch.setattr(pkg, "socket", SimpleNamespace(gethostname=lambda: "host"))
        w = pkg.SummaryWriter(str(tmp_path / name))
        w.add_scalars("Train", {"loss": 1.25, "dice_en": 0.5}, 0)
        w.add_scalars("Train", {"loss": 0.75}, 2**40)
        w.add_scalar("Val/td", 93.125, 7)
        w.close()
        out[name] = _tree_bytes(str(tmp_path / name))
    assert out["port"] == out["jax"]
    assert sorted(out["port"]) == ["events.out.tfevents.1000.host", "scalars.jsonl"]


def test_lib_weight_map_matches_jax(env):
    r = np.random.default_rng(2)
    masks = [read_nifti(os.path.join(env["data_root"], "mask", n + "mask_cut.nii.gz")).array
             for n in env["names"][:1]]
    masks.append((r.random((20, 24, 28)) > 0.6).astype(np.uint8))
    for mask in masks:
        want = np.asarray(jax_lib_weight_map(jax.numpy.asarray(mask.astype(np.float32))))
        got = lib_weight_map(mask, device="cpu")
        assert got.dtype == torch.float32 and got.shape == mask.shape
        got = got.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got.astype(np.float16), want.astype(np.float16))
        assert (got[mask == 0] == 0).all() and got.max() > 0
    # the weights the JAX prior writer stored
    stored = np.load(os.path.join(env["file_root"], "LIB_weight", env["names"][0] + ".npy"))
    np.testing.assert_array_equal(lib_weight_map(masks[0], device="cpu").numpy()
                                  .astype(np.float16), stored)


def test_lib_weight_map_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lib_weight_map(np.zeros((8, 8, 8), np.uint8))


def test_msgpack_params_load_bit_exact(tmp_path):
    """A JAX `save_params` file of `init_params` loads into the tree the
    weight bridge gives from the same numpy parameters."""
    params = jax.tree.map(np.asarray, jax.jit(lambda k: init_params(k, JaxConfig()))(
        jax.random.key(3)))
    path = jckpt.save_params(params, str(tmp_path), 4)
    assert path.endswith("SE_UNet_4.msgpack")
    got = pckpt.load_params(path)
    want = params_from_state_dict(state_dict_from_jax_params(params))
    flat_got, flat_want = dict(pckpt._paths(got)), dict(pckpt._paths(want))
    assert flat_got.keys() == flat_want.keys() and len(flat_got) > 100
    for k, t in flat_want.items():
        assert flat_got[k].dtype == t.dtype == torch.float32
        assert torch.equal(flat_got[k], t), k
    # and the port's model runs on it
    model = SEUNet(SEUNetConfig())
    model.load_state_dict(state_dict_from_jax_params(params))


@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, -1, -32, -33, -128,
    -129, -32768, -32769, -2**31, -2**31 - 1, -2**63, 0.5, -1e300, True, False, None,
    "", "a" * 31, "é" * 20, "b" * 300, "c" * 70000, b"", b"\x00" * 300, b"x" * 70000,
    [], list(range(20)), list(range(70000)), {"k": {str(i): i for i in range(20)}},
    {str(i): [i] for i in range(70000)},
    np.arange(6, dtype=np.float32).reshape(2, 3), np.zeros((0, 4), np.int16),
    np.array(2.5, np.float64), np.arange(5, dtype=np.uint8), np.ones((2, 2, 2), np.bool_),
    np.float32(1.5), np.int64(-7),
])
def test_msgpack_reader_matches_flax(obj):
    import flax.serialization

    data = flax.serialization.msgpack_serialize(obj)
    got = pckpt.msgpack_restore(data)
    want = flax.serialization.msgpack_restore(data)
    if isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want
    with pytest.raises(ValueError):
        pckpt.msgpack_restore(data + b"\xc0")


def test_state_roundtrip_across_leaf_order(tmp_path):
    """save_state / load_state: parameters, AdamW moments and step come
    back, also into a tree whose keys run in another order; the next
    step matches the uninterrupted one."""
    tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(1)).params_tree()
    opt, _ = make_optimizer()
    r = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(r.random((1, 16, 16, 16, 2)).astype(np.float32)),
             "label": torch.from_numpy((r.random((1, 16, 16, 16)) > 0.7).astype(np.float32))}
    draws = [torch.from_numpy(r.random((1, c)).astype(np.float32)) for c in (24, 12)]
    step = make_train_step(SEUNetConfig(), stage=1)
    state = create_train_state(tree, opt)
    state, _ = step(state, batch, drop_draws=draws)
    path = pckpt.save_state(state, str(tmp_path), 0)
    assert os.path.basename(path) == "state_0.pt"

    reordered = {k: dict(reversed(list(v.items()))) if isinstance(v, dict) else v
                 for k, v in reversed(list(tree.items()))}
    fresh = create_train_state(reordered, opt)
    fresh = pckpt.load_state(path, fresh)
    assert fresh.step == state.step == 1
    for p, leaf in pckpt._paths(state.params):
        t = fresh.params
        for k in p:
            t = t[k]
        assert torch.equal(t, leaf)
        m_old, m_new = state.optimizer.state[leaf], fresh.optimizer.state[t]
        assert m_old.keys() == m_new.keys()  # none for dc62, which no output reads
        for key in m_old:
            assert torch.equal(m_old[key], m_new[key]), (p, key)
    state, a = step(state, batch, drop_draws=draws)
    fresh, b = step(fresh, batch, drop_draws=draws)
    assert float(a["loss"]) == float(b["loss"])
    for p, leaf in pckpt._paths(state.params):
        t = fresh.params
        for k in p:
            t = t[k]
        assert torch.equal(t, leaf), p


def _failing(n_ok: int):
    for i in range(n_ok):
        yield {"i": i}
    raise OSError("truncated gzip stream")


def test_prefetcher_reraises_where_jax_ends_early(monkeypatch):
    """The JAX Prefetcher ends an epoch silently at a failing volume (the
    failure goes to the thread's excepthook only); the port's hands the
    batches before it, then raises the failure."""
    lost = []
    monkeypatch.setattr(threading, "excepthook", lambda args: lost.append(args.exc_value))
    jp = jds.Prefetcher(_failing(2))
    assert [b["i"] for b in jp] == [0, 1]
    jp.thread.join(timeout=10)
    assert not jp.thread.is_alive() and [str(e) for e in lost] == ["truncated gzip stream"]
    seen = []
    with pytest.raises(OSError, match="truncated gzip stream"):
        for b in pds.Prefetcher(_failing(2)):
            seen.append(b["i"])
    assert seen == [0, 1]
    assert [b["i"] for b in pds.Prefetcher(iter([{"i": 5}]))] == [5]
