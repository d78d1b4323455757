"""The port's prior writers, tree-parsing CLI and JAX full-state import
against the JAX package, on the CPU, on the 40^3 tube cases of
`test_torch_data.make_env` (two train cases, one val) and on JAX's
Y-tree:

* `save_lib_weights`: the float32 maps within 1e-6 of JAX's, the float16
  files equal; `save_skeletons_and_parses`: equal files;
* `save_weight_break`: equal `.npy` files on a hand-broken prediction (an
  axial gap) and on a prediction without a false negative (the
  `maxf == 0` branch);
* `save_stage_pred` on JAX's DropLayer draws (`fold_in(key(1), i)` per
  case, handed to the port as `drop_draws`), with the JAX runner on its
  reference-layout forward (`fast=False`: JAX's float32 `apply_fast`
  loses about 2e-4 on near-uniform tissue, ROADMAP Queue 3). The masks
  are equal except where the port's float64 averaged logit lies within
  1e-3 of the 0.5 threshold (the port's float32 fast path lies within
  1e-5 of it: tests/test_torch_engine.py::test_scores_against_float64);
* the tree-parsing CLI: the same artifact set, equal parse maps, branch
  counts and `_parse.npy` (an object array, compared element by element);
* a JAX `state_<ep>.msgpack` (seeded non-zero moments, count 3): loaded
  into the port's TrainState, one torch AdamW step and one optax update
  on the same seeded gradients agree within 1e-6 of each result's terms
  (the parameters with 2e-5 of the update's size more: optax forms the
  bias corrections in float32, where 1 - 0.999**4 keeps about 5
  digits); written with a
  `resume_meta.json` into a stage directory, it makes `train_stage1`
  resume at the next epoch from those moments and that step.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from se_unet_airseg_tpu.cli import tree_parsing as jcli
from se_unet_airseg_tpu.infer import sliding_window as jsw
from se_unet_airseg_tpu.io import read_nifti, write_nifti
from se_unet_airseg_tpu.models.se_unet import SEUNetConfig as JaxConfig
from se_unet_airseg_tpu.ops import lib_weight_map as jax_lib_weight_map
from se_unet_airseg_tpu.pipeline import priors as jpri
from se_unet_airseg_tpu.train import checkpoint as jckpt
from se_unet_airseg_tpu.train import step as jstep
from se_unet_airseg_tpu_torch.cli import tree_parsing as pcli
from se_unet_airseg_tpu_torch.infer import SlidingWindowRunner
from se_unet_airseg_tpu_torch.models import SEUNet, SEUNetConfig, jax_params_from_torch
from se_unet_airseg_tpu_torch.ops.lib_filter import lib_weight_map
from se_unet_airseg_tpu_torch.pipeline import priors as ppri
from se_unet_airseg_tpu_torch.train import create_train_state, make_optimizer
from se_unet_airseg_tpu_torch.train import stages as pstages
from se_unet_airseg_tpu_torch.train.checkpoint import _paths, load_state

from test_cli import _y_tree_mask
from test_torch_data import GAP, make_env
from test_torch_sliding_window import CUBE, STEP, _n_batches, jax_drop_draws
from test_torch_sliding_window import torch_threads  # noqa: F401
from test_torch_stages_port import _watch_steps


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_env(tmp_path_factory.mktemp("priors"), n_train=2)


def _same_nifti(a: str, b: str):
    va, vb = read_nifti(a), read_nifti(b)
    assert va.array.dtype == vb.array.dtype and va.array.shape == vb.array.shape
    np.testing.assert_array_equal(va.array, vb.array)
    assert va.spacing == vb.spacing and va.origin == vb.origin


def _same_npy(a: str, b: str):
    x, y = np.load(a), np.load(b)
    assert x.dtype == y.dtype and x.shape == y.shape
    np.testing.assert_array_equal(x, y)
    return x


def test_lib_weights_and_skeletons_match_jax(env, tmp_path):
    fr, mask_dir = env["file_root"], os.path.join(env["data_root"], "mask")
    ppri.save_lib_weights(mask_dir, str(tmp_path / "LIB_weight"), device="cpu")
    for n in env["names"]:
        mask = read_nifti(os.path.join(mask_dir, n + "mask_cut.nii.gz")).array
        want = np.asarray(jax_lib_weight_map(jnp.asarray((mask > 0).astype(np.float32))))
        got = lib_weight_map((mask > 0).astype(np.float32), device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        w = _same_npy(str(tmp_path / "LIB_weight" / f"{n}.npy"),
                      os.path.join(fr, "LIB_weight", f"{n}.npy"))
        assert w.dtype == np.float16 and w.max() > 0
    for split, suffix in (("train", ""), ("val", "_val")):
        ppri.save_skeletons_and_parses(mask_dir, env["file_path"],
                                       str(tmp_path / f"tree_parse{suffix}"),
                                       str(tmp_path / f"skeleton{suffix}"), split=split)
        for n in env[split]:
            for d in ("tree_parse", "skeleton"):
                _same_nifti(str(tmp_path / f"{d}{suffix}" / f"{n}mask_cut.nii.gz"),
                            os.path.join(fr, f"{d}{suffix}", f"{n}mask_cut.nii.gz"))


def test_weight_break_matches_jax(env, tmp_path):
    """CASE001's prediction is its whole mask (no false negative: the
    `maxf == 0` branch); the others have make_env's axial gap."""
    pred_dir = tmp_path / "pred_2"
    os.makedirs(pred_dir)
    for n in env["names"]:
        src = os.path.join(env["file_root"], "pred_2", f"{n}.nii.gz")
        if n == "CASE001":
            src = os.path.join(env["data_root"], "mask", f"{n}mask_cut.nii.gz")
            write_nifti(str(pred_dir / f"{n}.nii.gz"), read_nifti(src).array[None])
        else:
            write_nifti(str(pred_dir / f"{n}.nii.gz"), read_nifti(src).array)
    out = {}
    for name, mod in (("port", ppri), ("jax", jpri)):
        out[name] = (tmp_path / name / "BR_weight", tmp_path / name / "br_skel")
        mod.save_weight_break(env["data_root"], str(pred_dir), *map(str, out[name]),
                              env["file_path"])
    for n in env["names"]:
        w = _same_npy(out["port"][0] / f"{n}.npy", out["jax"][0] / f"{n}.npy")
        coords = _same_npy(out["port"][1] / f"{n}.npy", out["jax"][1] / f"{n}.npy")
        assert w.dtype == np.float16 and coords.shape[0] == 3
        if n == "CASE001":
            assert coords.shape == (3, 0) and not w.any()
        else:  # the break skeleton lies in the gap, the weight around it
            assert coords.shape[1] > 0 and set(coords[2]) <= set(range(GAP.start, GAP.stop))
            assert np.isfinite(w.astype(np.float32)).all() and w.max() > 0


def test_stage_pred_matches_jax_on_its_draws(env, tmp_path, monkeypatch):
    tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(5)).params_tree()
    jp = jax_params_from_torch(tree)
    monkeypatch.setattr(jsw, "SlidingWindowRunner",
                        functools.partial(jsw.SlidingWindowRunner, fast=False))
    jpri.save_stage_pred(jp, JaxConfig(), env["file_path"], env["data_root"],
                         str(tmp_path / "jax"), cube=CUBE, step=STEP)
    names = sorted(env["names"])
    vols = [read_nifti(os.path.join(env["data_root"], "data", n + "data_cut.nii.gz")).array
            for n in names]
    draws = [jax_drop_draws(jax.random.fold_in(jax.random.key(1), i),
                            _n_batches(v.shape, batch=1), 1) for i, v in enumerate(vols)]
    ppri.save_stage_pred(tree, SEUNetConfig(), env["file_path"], env["data_root"],
                         str(tmp_path / "port"), cube=CUBE, step=STEP, device="cpu",
                         drop_draws=draws)
    f64 = SlidingWindowRunner(jax.tree.map(lambda t: t.double(), tree),
                              SEUNetConfig(compute_dtype=torch.float64), use_sigmoid=False,
                              train_mode=True, cube=CUBE, step=STEP, device="cpu")
    for n, vol, dr in zip(names, vols, draws):
        got, want = (read_nifti(str(tmp_path / d / f"{n}.nii.gz")) for d in ("port", "jax"))
        assert got.array.shape == want.array.shape and got.array.size == vol.size
        assert got.array.dtype == want.array.dtype == np.uint8
        assert 0 < want.array.sum() < want.array.size
        diff = (got.array != want.array).reshape(vol.shape)
        if diff.any():  # a flip is allowed only next to the threshold
            logit = f64.predict_hu(vol, hu_shift=-1024.0,
                                   drop_draws=[[r.double() for r in b] for b in dr])
            assert (np.abs(logit - 0.5) < 1e-3)[diff].all(), n


def test_tree_parsing_cli_matches_jax(tmp_path):
    masks = tmp_path / "masks"
    os.makedirs(masks)
    # (z, y, x) on disk with y == x triggers the reference's axis heuristic
    write_nifti(str(masks / "CASE001.nii.gz"), _y_tree_mask().transpose(2, 0, 1))
    for name, mod in (("port", pcli), ("jax", jcli)):
        mod.main(["--pred_mask_path", str(masks), "--save_path", str(tmp_path / name / "ours"),
                  "--save_ATM22_path", str(tmp_path / name / "atm22"), "--merge_t", "5"])
    for parser in ("ours", "atm22"):
        got, want = tmp_path / "port" / parser, tmp_path / "jax" / parser
        assert sorted(os.listdir(got)) == sorted(os.listdir(want))
        _same_nifti(str(got / "CASE001_parse_map.nii.gz"), str(want / "CASE001_parse_map.nii.gz"))
        lines = [(p / "CASE001_time.txt").read_text().splitlines() for p in (got, want)]
        assert [len(x) for x in lines] == [3, 3] and lines[0][-1] == lines[1][-1]
        assert int(lines[0][-1].split()[-1]) >= 3
    parse = read_nifti(str(tmp_path / "port" / "ours" / "CASE001_parse_map.nii.gz")).array
    assert (parse > 0).sum() == _y_tree_mask().sum()
    got = np.load(tmp_path / "port" / "ours" / "CASE001_parse.npy", allow_pickle=True)
    want = np.load(tmp_path / "jax" / "ours" / "CASE001_parse.npy", allow_pickle=True)
    assert got.dtype == want.dtype == object and len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _jax_full_state(tree, seed: int, count: int = 3, lr: float = 3e-4):
    """A JAX TrainState over `tree`'s parameters in the JAX layout, with
    seeded non-zero AdamW moments, optax count and step `count`."""
    opt, _ = jstep.make_optimizer()
    params = jax.tree.map(jnp.asarray, jax_params_from_torch(tree))
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda p: jnp.asarray(rng.normal(0, 1e-3, p.shape), jnp.float32), params)
    nu = jax.tree.map(lambda p: jnp.asarray(rng.uniform(1e-8, 1e-5, p.shape), jnp.float32),
                      params)
    opt_state = jax.jit(opt.init)(params)
    inner = opt_state.inner_state
    adam = inner[0]._replace(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu)
    opt_state = opt_state._replace(count=jnp.asarray(count, jnp.int32),
                                   inner_state=(adam,) + tuple(inner[1:]))
    state = jstep.TrainState(params, opt_state, jnp.asarray(count, jnp.int32))
    return opt, jstep.set_learning_rate(state, lr)


def _close(got, want, scale, rtol=1e-6):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= rtol * scale).all(), np.abs(got - want).max()


def test_jax_full_state_loads_and_steps_like_optax(tmp_path):
    tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(2)).params_tree()
    opt, jstate = _jax_full_state(tree, seed=3)
    path = jckpt.save_state(jstate, str(tmp_path), 4)
    state = load_state(path, create_train_state(tree, make_optimizer()[0]))
    assert state.step == 3
    (group,) = state.optimizer.param_groups
    assert (group["lr"], group["weight_decay"]) == (pytest.approx(3e-4), pytest.approx(1e-2))
    mu = dict(_paths(jstate.opt_state.inner_state[0].mu))
    for p, leaf in _paths(state.params):
        st = state.optimizer.state[leaf]
        assert float(st["step"]) == 3.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(mu[p]))

    inner = jstate.opt_state.inner_state[0]
    m0, n0 = (dict(_paths(jax.tree.map(np.asarray, t))) for t in (inner.mu, inner.nu))
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: rng.normal(0, 1e-2, p.shape).astype(np.float32),
                         jax_params_from_torch(tree))
    g = dict(_paths(grads))
    for p, leaf in _paths(state.params):
        leaf.grad = torch.from_numpy(g[p])
    state.optimizer.step()
    updates, opt_state = jax.jit(opt.update)(grads, jstate.opt_state, jstate.params)
    want = dict(_paths(jax.jit(optax.apply_updates)(jstate.params, updates)))
    adam = opt_state.inner_state[0]
    mu, nu = dict(_paths(adam.mu)), dict(_paths(adam.nu))
    b1, b2 = 0.9, 0.999
    old = jax_params_from_torch(tree)
    for p, leaf in _paths(state.params):
        st, gp = state.optimizer.state[leaf], g[p]
        # each result within 1e-6 of the magnitude of the terms it sums:
        # torch forms the moments by lerp and decays before the step,
        # optax sums b * m + (1 - b) * g and decays inside the update.
        # optax also forms the bias corrections in float32, where
        # 1 - 0.999**4 keeps only about 5 digits: the update itself
        # carries up to 1.5e-5 of its size, so it gets 2e-5 of it
        p0 = dict(_paths(old))[p]
        _close(leaf.detach().numpy(), want[p],
               np.abs(want[p]) + 20 * np.abs(np.asarray(want[p]) - p0))
        _close(st["exp_avg"].numpy(), mu[p], b1 * np.abs(m0[p]) + (1 - b1) * np.abs(gp))
        _close(st["exp_avg_sq"].numpy(), nu[p], b2 * n0[p] + (1 - b2) * gp ** 2)
        assert float(st["step"]) == int(adam.count) == 4


def test_stage1_resumes_a_jax_full_state(env, tmp_path, monkeypatch):
    cfg = pstages.StageConfig(
        data_root=env["data_root"], file_root=env["file_root"], file_path=env["file_path"],
        model_savepath=str(tmp_path / "model"), log_savepath=str(tmp_path / "LOG.txt"),
        epochs=2, batch_size=1, cube=32, device="cpu")
    tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(6)).params_tree()
    _, jstate = _jax_full_state(tree, seed=7, lr=1e-4)
    jckpt.save_state(jstate, cfg.model_savepath, 0)
    (tmp_path / "model" / "resume_meta.json").write_text("{}")
    seen = []
    _watch_steps(monkeypatch, seen)
    state = pstages.train_stage1(cfg)
    assert len(seen) == len(env["train"])  # epoch 1 only
    first = seen[0]
    assert first["step"] == 3 and state.step == 3 + len(env["train"])
    want = dict(_paths(jax_params_from_torch(tree)))
    mu = dict(_paths(jstate.opt_state.inner_state[0].mu))
    nu = dict(_paths(jstate.opt_state.inner_state[0].nu))
    for p, t in first["params"].items():
        np.testing.assert_array_equal(t.numpy(), want[p])
        m = first["moments"][p]
        assert float(m["step"]) == 3.0
        np.testing.assert_array_equal(m["exp_avg"].numpy(), np.asarray(mu[p]))
        np.testing.assert_array_equal(m["exp_avg_sq"].numpy(), np.asarray(nu[p]))
    assert sorted(os.listdir(cfg.model_savepath)) == [
        "SE_UNet_1.pt", "resume_meta.json", "state_0.msgpack", "state_1.pt"]
