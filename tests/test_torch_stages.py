"""The port's stage-1 driver (`train/stages.py::train_stage1`) against the
JAX package's, on the CPU, for 2 epochs on 40^3 tube cases
(`test_torch_data.make_env`: 2 training cases, 1 validation case), cube
24, batch 1, float32, one seeded weight set on both sides.
`tests/test_torch_stage2.py` runs the same tests on stage 2 (1 epoch,
with its online hard-mining cache and replay) from this module's drivers.

Both packages' step factories are wrapped (monkeypatch; the JAX files are
untouched) to record every step's batch, learning rate and loss. The port
gets JAX's draws: its `Draws` is replaced by one that splits
`jax.random.key(seed)` as the JAX drivers do (per step DropLayer draws,
per replay the shuffle seed), and its validation gets the JAX validation
draws of `tests/test_torch_engine.py` (key fold_in(key(0), epoch), folded
with the case and the tile batch). The JAX validation runs on the
reference-layout forward (`fast=False`; its float32 `apply_fast` departs
from float64 by about 2e-4 on near-uniform tissue, ROADMAP Queue 3) in one
runner reused through `set_params`, as the drivers reuse theirs.

Compared: every step's batch (equal) and learning rate (equal); the
losses within LOSS_RTOL; the final parameters within PARAM_ATOL; the
validation results (TD/BD within METRIC_ATOL percentage points, the Dice
losses within METRIC_ATOL / 100); `resume_meta.json` (ratios equal,
history within the metric tolerances); the LOG blocks' form; the files
each epoch writes.

Tolerances. One step of the two packages agrees to about 1e-6 in the
loss and 5e-3 relative in each gradient (tests/test_torch_train_step.py).
AdamW divides each gradient element by its own magnitude, so an element
near zero (a conv bias in front of an InstanceNorm) may step by up to
+-lr on either side: after N steps a parameter may differ by up to
2 N lr (N = 4 in stage 1, 4 + 1 replay in stage 2; measured: 6e-4 after
8 steps). The losses of later steps carry those parameter differences:
LOSS_RTOL 1e-3 (measured: 8e-5). Validation metrics: METRIC_ATOL 0.5
(tests/test_torch_engine.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_unet_airseg_tpu.infer import engine as jeng
from se_unet_airseg_tpu.infer import sliding_window as jsw
from se_unet_airseg_tpu.infer.sliding_window import SlidingWindowRunner as JaxRunner
from se_unet_airseg_tpu.models.se_unet import SEUNetConfig as JaxConfig
from se_unet_airseg_tpu.train import stages as jstages
from se_unet_airseg_tpu_torch.data import pad_positions_to_batch, tile_positions
from se_unet_airseg_tpu_torch.infer import engine as peng
from se_unet_airseg_tpu_torch.models import SEUNet, SEUNetConfig, jax_params_from_torch
from se_unet_airseg_tpu_torch.train import current_learning_rate
from se_unet_airseg_tpu_torch.train import stages as pstages
from se_unet_airseg_tpu_torch.train.checkpoint import _paths, load_params

from test_torch_data import SIDE, make_env
from test_torch_sliding_window import jax_drop_draws, torch_threads  # noqa: F401

CUBE, BATCH, SEED = 24, 1, 5
LR = 1e-4
N_TRAIN = {1: 2, 2: 4}  # training cases: stage 2 caches 30% of its 4 crops
CACHE_LIMIT = int(N_TRAIN[2] * BATCH * 0.3)  # the drivers' rule: 1 crop
N_STEPS = {1: 2 * N_TRAIN[1], 2: N_TRAIN[2] + CACHE_LIMIT}  # stage 2: the replay's too
LOSS_RTOL = 1e-3
METRIC_ATOL = 0.5
N_VAL_BATCHES = len(pad_positions_to_batch(tile_positions((SIDE,) * 3, CUBE, CUBE // 2), 1))


class JaxDraws:
    """The JAX drivers' draws, as the port's `Draws`: per train step
    rng, sub = split(rng) and the DropLayer uniforms of sub as JAX
    `apply_fast` draws them; per replay pass the shuffle seed."""

    def __init__(self, seed, device):
        self.rng = jax.random.key(seed)

    def step(self, batch_size: int) -> dict:
        self.rng, sub = jax.random.split(self.rng)
        keys = jax.random.split(sub)
        return {"drop_draws": [
            torch.from_numpy(np.array(jax.random.uniform(
                k, (batch_size, 1, 1, 1, c), jnp.float32)).reshape(batch_size, c))
            for k, c in zip(keys, (24, 12))]}

    def shuffle_seed(self) -> int:
        self.rng, shuf = jax.random.split(self.rng)
        return int(jax.random.randint(shuf, (), 0, 2**31 - 1))


@pytest.fixture(scope="module")
def stage():
    return 1


@pytest.fixture(scope="module")
def env(tmp_path_factory, stage):
    e = make_env(tmp_path_factory.mktemp("stages"), n_train=N_TRAIN[stage])
    e["port_params"] = SEUNet(SEUNetConfig(),
                              generator=torch.Generator().manual_seed(SEED)).params_tree()
    return e


def _cfg(pkg, env, side: str, stage: int, start_params, **kw):
    root = env["root"] / side
    fr = env["file_root"]
    extra = {} if stage == 1 else {
        "milestones": (40, 60), "pred_path": os.path.join(fr, "pred_1"),
        "online_savepath": str(root / "online")}
    return pkg.StageConfig(
        data_root=env["data_root"], file_root=fr, file_path=env["file_path"],
        model_savepath=str(root / f"stage{stage}"), log_savepath=str(root / "LOG.txt"),
        epochs=2 if stage == 1 else 1, batch_size=BATCH, cube=CUBE, seed=SEED + stage,
        start_params=start_params, **extra, **kw)


def _recorder(make, log: list, lr_of, host):
    """`make` (a make_resilient_step) whose steps also append (batch,
    learning rate, loss, per-crop losses) to `log`."""
    def factory(*args, **kw):
        step = make(*args, **kw)

        def recorded(state, batch, *a, **k):
            lr = lr_of(state)
            state, aux = step(state, batch, *a, **k)
            log.append({"batch": {n: host(v) for n, v in batch.items()}, "lr": lr,
                        "loss": float(aux["loss"]),
                        "per_crop": host(aux["per_crop_gul"]) if "per_crop_gul" in aux
                        else None})
            return state, aux
        return recorded
    return factory


def _val_recorder(validate, out: list, extra=lambda args: {}):
    def call(*args, **kw):
        res = validate(*args, **kw, **extra(args))
        out.append(tuple(float(v) for v in res))
        return res
    return call


def _cache_listing(root: str) -> dict:
    return {d: sorted(os.listdir(os.path.join(root, d))) for d in sorted(os.listdir(root))}


def _train(pkg, stage: int):
    return pkg.train_stage1 if stage == 1 else pkg.train_stage2


@pytest.fixture(scope="module")
def jax_run(env, stage):
    """The JAX driver of `stage` from the port's seeded weights, its steps
    and validation recorded."""
    runners = {}

    def shared_runner(params, cfg, **kw):
        """One reference-layout runner per tiling, reused via set_params."""
        key = (kw["cube"], kw["step"])
        if key not in runners:
            runners[key] = JaxRunner(params, cfg, fast=False, **kw)
        return runners[key].set_params(params)

    log, val = [], []
    with pytest.MonkeyPatch.context() as mp:
        # stage 2 of the JAX drivers sets this knob (read only under remat)
        # where it is unset; scoped here so it does not outlive the run
        mp.setenv("REMAT_SKIP_WHOLEBLOCK", "0")
        mp.setattr(jeng, "SlidingWindowRunner", shared_runner)
        mp.setattr(jsw, "SlidingWindowRunner", shared_runner)
        mp.setattr(jstages, "_validate", _val_recorder(jstages._validate, val))
        mp.setattr(jstages, "make_resilient_step", _recorder(
            jstages.make_resilient_step, log,
            lambda s: float(s.opt_state.hyperparams["learning_rate"]), np.array))
        state = _train(jstages, stage)(_cfg(jstages, env, "jax", stage,
                                            jax_params_from_torch(env["port_params"]),
                                            model_cfg=JaxConfig()))
    out = {"log": log, "val": val, "params": jax.tree.map(np.array, state.params),
           "steps": int(state.step)}
    if stage > 1:
        out["cache"] = _cache_listing(str(env["root"] / "jax" / "online"))
    return out


@pytest.fixture(scope="module")
def port_run(env, stage, torch_threads):  # noqa: F811
    """The port's driver of `stage` on JAX's draws, recorded likewise."""
    log, val = [], []

    def draws(args):
        rng = jax.random.fold_in(jax.random.key(0), args[5])  # the JAX validate's key
        return {"drop_draws": [jax_drop_draws(jax.random.fold_in(rng, i), N_VAL_BATCHES, 1)
                               for i in range(len(env["val"]))]}

    def host(t):
        return t.detach().cpu().numpy().copy()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pstages, "Draws", JaxDraws)
        mp.setattr(peng, "validate", _val_recorder(peng.validate, val, draws))
        mp.setattr(pstages, "make_resilient_step", _recorder(
            pstages.make_resilient_step, log, current_learning_rate, host))
        state = _train(pstages, stage)(_cfg(pstages, env, "port", stage, env["port_params"],
                                            device="cpu"))
    out = {"log": log, "val": val, "params": jax_params_from_torch(state.params),
           "steps": state.step, "state": state}
    if stage > 1:
        out["cache"] = _cache_listing(str(env["root"] / "port" / "online"))
    return out


def test_steps_match_jax(jax_run, port_run, stage):
    got, want = port_run["log"], jax_run["log"]
    assert len(got) == len(want) == port_run["steps"] == jax_run["steps"] == N_STEPS[stage]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["batch"].keys() == w["batch"].keys(), i
        for k in w["batch"]:
            np.testing.assert_array_equal(g["batch"][k], w["batch"][k], err_msg=f"{i} {k}")
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-7) and g["lr"] == LR
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL, err_msg=str(i))
        if stage > 1:
            np.testing.assert_allclose(g["per_crop"], w["per_crop"], rtol=LOSS_RTOL)
    if stage > 1:  # the replay's B=1 step on the cached crop comes last
        assert got[-1]["batch"]["image"].shape[0] == 1 and "weight" in got[-1]["batch"]


def test_final_params_match_jax(jax_run, port_run, stage):
    flat_g = jax.tree_util.tree_flatten_with_path(port_run["params"])[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(jax_run["params"])[0])
    assert len(flat_g) == len(flat_w)
    atol = 2 * N_STEPS[stage] * LR + 1e-6
    worst = 0.0
    for path, g in flat_g:
        d = float(np.abs(g - np.asarray(flat_w[path])).max())
        assert d <= atol, (jax.tree_util.keystr(path), d)
        worst = max(worst, d)
    assert worst > 0  # the two packages trained, each in its own float order


def test_validation_matches_jax(env, jax_run, port_run, stage):
    got, want = port_run["val"], jax_run["val"]
    assert len(got) == len(want) == 1  # stage 1's last epoch; stage 2's epoch
    np.testing.assert_allclose(got[0][:2], want[0][:2], atol=METRIC_ATOL)
    np.testing.assert_allclose(got[0][2:], want[0][2:], atol=METRIC_ATOL / 100)
    if stage > 1:
        assert 0 < want[0][2] and 0 < want[0][3]
    logs = [(env["root"] / side / "LOG.txt").read_text().split("\n") for side in ("port", "jax")]
    epoch = 1 if stage == 1 else 0
    assert logs[0][0] == logs[1][0] == f"epoch:{epoch}"
    assert logs[0][2:] == logs[1][2:] == ["", ""]
    metas = [json.loads((env["root"] / side / f"stage{stage}" / "resume_meta.json").read_text())
             for side in ("port", "jax")]
    assert metas[0].keys() == metas[1].keys()
    if stage == 1:
        assert metas[0] == {}
        return
    assert metas[0]["hard_ratio"] == metas[1]["hard_ratio"] == 0.4
    for k in ("td", "bd", "tr", "th"):
        np.testing.assert_allclose(metas[0]["hist"][k], metas[1]["hist"][k],
                                   atol=METRIC_ATOL if k in ("td", "bd") else METRIC_ATOL / 100)


def test_checkpoints_written(env, port_run, stage):
    epochs = 2 if stage == 1 else 1
    d = env["root"] / "port" / f"stage{stage}"
    want = [f"SE_UNet_{e}.pt" for e in range(epochs)] + ["resume_meta.json"] + \
        [f"state_{e}.pt" for e in range(epochs)]
    assert sorted(os.listdir(d)) == sorted(want)
    saved = load_params(str(d / f"SE_UNet_{epochs - 1}.pt"))
    for (p, t), (q, u) in zip(_paths(saved), _paths(port_run["state"].params)):
        assert p == q and torch.equal(t, u.detach())
    tb = env["root"] / "port" / "tb"
    assert any(f.startswith("events.out.tfevents.") for f in os.listdir(tb))
    lines = (tb / "scalars.jsonl").read_text().splitlines()
    assert len(lines) == epochs * N_TRAIN[stage]  # the main pass's steps
    assert {"Train/loss", "Train/dice_de" if stage == 1 else "Train/gul_de"} <= set(
        json.loads(lines[-1]))


def test_mesh_and_replay_bucket_raise(env, stage):
    """A mesh is a parallel.DataMesh (the drivers on one:
    tests/test_torch_parallel_drivers.py); anything else is rejected, with
    or without `replay_bucket`."""
    for kw in ({"mesh": object()}, {"mesh": object(), "replay_bucket": True}):
        with pytest.raises(TypeError, match="DataMesh"):
            _train(pstages, stage)(_cfg(pstages, env, "raise", stage, None, device="cpu", **kw))


def test_drivers_need_a_device_without_cuda(env, stage):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _train(pstages, stage)(_cfg(pstages, env, "nodev", stage, None))
