"""The port's stage drivers on their own, on the CPU (40^3 tube cases of
`test_torch_data.make_env`, 2 training cases, cube 24, batch 1, and 2 in
stage 3, float32):

* resume (the analogue of tests/test_resume.py): stage 1 "crashes" after
  one epoch; restarted for 3 epochs it resumes at epoch 1, its first step
  starts from the saved parameters, AdamW moments and step, the step
  count continues, and only the two newest full states stay;
* stage 3 for one epoch on the engineered break priors (an axial gap cut
  through the main tube): losses finite, the atr loss on, the online
  cache holding the skeleton channel, the replay at batch 1, the
  scheduler's ratios in `resume_meta.json`; then a restart of the same
  stage with 2 epochs resumes with that scheduler state and history;
* a `.msgpack` parameter file of the JAX package as `start_params`.
"""

import json
import math
import os
import re

import pytest
import torch

from se_unet_airseg_tpu.train import checkpoint as jckpt
from se_unet_airseg_tpu_torch.models import SEUNet, SEUNetConfig, jax_params_from_torch
from se_unet_airseg_tpu_torch.train import stages as pstages
from se_unet_airseg_tpu_torch.train.checkpoint import _paths, load_params

from test_torch_data import make_env
from test_torch_sliding_window import torch_threads  # noqa: F401

CUBE, BATCH = 24, 2


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_env(tmp_path_factory.mktemp("port_stages"), n_train=2)


def _cfg(env, name: str, epochs: int, stage: int = 1, batch: int = BATCH, **kw):
    root, fr = env["root"] / name, env["file_root"]
    if stage == 3:
        kw.update(milestones=(40, 60), pred_path=os.path.join(fr, "pred_2"),
                  br_skel_path=os.path.join(fr, "br_skel"),
                  br_weight_path=os.path.join(fr, "BR_weight"),
                  online_savepath=str(root / "online"))
    return pstages.StageConfig(
        data_root=env["data_root"], file_root=fr, file_path=env["file_path"],
        model_savepath=str(root / "model"), log_savepath=str(root / "LOG.txt"),
        epochs=epochs, batch_size=batch, cube=CUBE, device="cpu", **kw)


def _watch_steps(monkeypatch, seen: list):
    """Record (state.step, batch size, a copy of the parameters and AdamW
    moments before the step, loss, aux keys) of every driver step."""
    make = pstages.make_resilient_step

    def factory(*a, **k):
        step = make(*a, **k)

        def watched(state, batch, *args, **kw):
            before = {"step": state.step,
                      "params": {p: t.detach().clone() for p, t in _paths(state.params)},
                      "moments": {p: {k: v.clone() for k, v in state.optimizer.state[t].items()}
                                  for p, t in _paths(state.params)
                                  if t in state.optimizer.state}}
            state, aux = step(state, batch, *args, **kw)
            seen.append({**before, "b": batch["image"].shape[0], "loss": float(aux["loss"]),
                         "aux": set(aux)})
            return state, aux
        return watched

    monkeypatch.setattr(pstages, "make_resilient_step", factory)


def test_stage1_resumes_from_state(env, monkeypatch):
    seen = []
    _watch_steps(monkeypatch, seen)
    first = pstages.train_stage1(_cfg(env, "resume", 1, batch=1))  # "crash" after one epoch
    model = env["root"] / "resume" / "model"
    assert sorted(os.listdir(model)) == ["SE_UNet_0.pt", "resume_meta.json", "state_0.pt"]
    saved = torch.load(model / "state_0.pt", weights_only=True)
    assert saved["step"] == first.step == len(env["train"])  # one step per volume
    n_first = len(seen)

    state = pstages.train_stage1(_cfg(env, "resume", 3, batch=1))
    resumed = seen[n_first]
    assert resumed["step"] == saved["step"]
    for p, t in _paths(saved["params"]):
        assert torch.equal(resumed["params"][p], t), p
    order = [tuple(p) for p in saved["order"]]
    assert len(resumed["moments"]) > 100
    for i, moments in saved["optimizer"]["state"].items():
        got = resumed["moments"][order[int(i)]]
        assert got.keys() == moments.keys()
        for k in moments:
            assert torch.equal(got[k], moments[k]), (order[int(i)], k)
    assert state.step == saved["step"] + 2 * len(env["train"])
    assert all(math.isfinite(s["loss"]) for s in seen)
    saved_files = sorted(os.listdir(model))
    assert saved_files == ["SE_UNet_0.pt", "SE_UNet_1.pt", "SE_UNet_2.pt", "resume_meta.json",
                           "state_1.pt", "state_2.pt"]
    # stage 1 validates at its last epoch: 0 of the first run, 2 of the second
    log = (env["root"] / "resume" / "LOG.txt").read_text()
    assert re.findall(r"^epoch:(\d+)$", log, re.M) == ["0", "2"]


def test_stage3_one_epoch_then_resume(env, monkeypatch):
    seen = []
    _watch_steps(monkeypatch, seen)
    pstages.train_stage3(_cfg(env, "stage3", 1, stage=3))
    limit = int(len(env["train"]) * BATCH * 0.3)
    assert [s["b"] for s in seen] == [BATCH] * len(env["train"]) + [1] * limit
    assert all(math.isfinite(s["loss"]) for s in seen)
    assert all({"atr_en", "atr_de", "per_crop_gul"} <= s["aux"] for s in seen)
    online = env["root"] / "stage3" / "online"
    assert sorted(os.listdir(online)) == ["image", "label", "skel", "weight"]
    assert all(len(os.listdir(online / d)) == limit for d in os.listdir(online))
    meta_path = env["root"] / "stage3" / "model" / "resume_meta.json"
    meta = json.loads(meta_path.read_text())
    assert list(meta) == ["hard_ratio", "break_ratio", "hist"]
    assert (meta["hard_ratio"], meta["break_ratio"]) == (0.8, 0.625)  # no update at epoch 0
    assert all(len(v) == 1 and math.isfinite(v[0]) for v in meta["hist"].values())
    assert "TD:" in (env["root"] / "stage3" / "LOG.txt").read_text()

    # a restart for 2 epochs resumes at epoch 1 with the saved history
    meta["hard_ratio"], meta["break_ratio"] = 0.55, 0.3
    meta_path.write_text(json.dumps(meta))
    ratios = []
    orig = pstages.Stage3Crops.__iter__

    def iter_with_ratios(self):
        ratios.append((self.hard_ratio, self.break_ratio))
        return orig(self)

    monkeypatch.setattr(pstages.Stage3Crops, "__iter__", iter_with_ratios)
    pstages.train_stage3(_cfg(env, "stage3", 2, stage=3))
    assert ratios == [(0.55, 0.3)]
    meta2 = json.loads(meta_path.read_text())
    assert [len(v) for v in meta2["hist"].values()] == [2] * 4
    assert meta2["hist"]["td"][0] == meta["hist"]["td"][0]


def test_stage1_starts_from_a_jax_msgpack(env, tmp_path):
    tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(1)).params_tree()
    path = jckpt.save_params(jax_params_from_torch(tree), str(tmp_path), 0)
    cfg = _cfg(env, "msgpack", 1, batch=1, start_params=path, model_cfg=SEUNetConfig())
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        _watch_steps(mp, seen)
        pstages.train_stage1(cfg)
    want = load_params(path)
    for p, t in _paths(want):
        assert torch.equal(seen[0]["params"][p], t), p
