"""The port's data parallelism without JAX: the sharded step on 2 ranks
against one process, replicated batches, the out-of-memory fallback
across ranks, the replay's buckets, and the stage drivers on a mesh.

Ranks run over gloo on the CPU (`parallel.spawn`, one intra-op thread
each; the one-process runs here take one thread too, since a thread count
changes the float32 rounding of the convs). Every spawn has a timeout, so
a hang fails a test.

  * Sharded step, stage 2, B=4 at 16^3 on 2 ranks, against the port's
    step on the whole batch with the same generator's draws: the loss
    within rtol 1e-6, each gradient leaf within LEAF_RTOL of its norm.
  * Replicated batches (B=3, B=1, B=3 on 2 ranks): after the 3 steps the
    ranks' parameters and AdamW moments are bitwise equal, and equal to
    the one-process steps'.
  * Out of memory (`torch.cuda.OutOfMemoryError` raised in rank 1's
    forward, through `_make_step`): every rank falls back to remat=True
    once and retries the batch from unchanged parameters (the result is
    bitwise the remat step's); a second error, on rank 0, raises on every
    rank. Any other error on one rank raises on every rank before AdamW,
    with no fallback.
  * Replay buckets (JAX tests/test_resilience.py:156-227, rank 0 of 2):
    11 cached crops give 5 steps of 2 and 1 B=1 step with `replay_bucket`,
    11 B=1 steps without (the drivers below run both kinds of step).
  * Drivers, 2 ranks, 32^3 tube cases, cube 24, batch 2, float32:
    `train_stage2` for 1 epoch (4 main steps, the cache's 2 crops replayed
    at B=1), then resumed for a second epoch with `replay_bucket` (the 2
    crops in one sharded step); `train_stage1` for 1 epoch. Losses against the one-process drivers
    within LOSS_RTOL (the parameters drift as tests/test_torch_stages.py
    explains); every file written by rank 0 alone, as many times as one
    process writes it; the checkpoints load to the final parameters.
  * The losses' sums: the ratios equal the whole-batch formulas bitwise,
    the shards' sums add up to the whole batch's.
  * The benchmark's four-card driver (`portbench/drivers/train_stage1_dp.py::
    rank_steps`) on 2 ranks at 16^3, a global batch of 2, float32: rank 0
    cuts and broadcasts the batches, the checked steps, the window's step
    count from rank 0's timing, the comparison with the one-process
    reference; every check passes, the ranks' parameters bitwise equal
    after the checked steps (`rank_param_diff` 0).
  * `make_mesh(n_space=2)` on the 2 ranks: a (1, 2) mesh, each rank's
    depth slab from `batch_sharding(shard_space=True)`; what still raises:
    `conv_stats` / `conv_epi` with `space=` (ROADMAP M9b), `shard_space`
    without a mesh, objects that are not a mesh.
"""

import json
import os
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers import train_stage1_dp
from se_unet_airseg_tpu_torch import losses
from se_unet_airseg_tpu_torch.infer import SlidingWindowRunner
from se_unet_airseg_tpu_torch.io import write_nifti
from se_unet_airseg_tpu_torch.models import SEUNet, SEUNetConfig
from se_unet_airseg_tpu_torch.models.se_unet import _leaves, _tree_map, apply_fast, draw_dropout
from se_unet_airseg_tpu_torch.parallel import DataMesh, batch_sharding, make_mesh, spawn
from se_unet_airseg_tpu_torch.pipeline.priors import save_lib_weights, save_skeletons_and_parses
from se_unet_airseg_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_resilient_step,
    make_train_step,
)
from se_unet_airseg_tpu_torch.train import stages as pstages
from se_unet_airseg_tpu_torch.train import step as pstep
from se_unet_airseg_tpu_torch.train.checkpoint import load_params

S = 16
LEAF_RTOL = 1e-4  # measured: 1.56e-5 (each leaf above 1e-5 of the largest norm)
LOSS_RTOL = 1e-4  # measured: 4.6e-6
SIDE, CUBE, BATCH = 32, 24, 2
N_TRAIN = 4
TIMEOUT_S = 240


def _tree():
    return SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(3)).params_tree()


def _batch(b: int, seed: int = 4) -> dict:
    r = np.random.default_rng(seed)
    label = (r.random((b, S, S, S)) > 0.7).astype(np.float32)
    return {"image": r.random((b, S, S, S, 2)).astype(np.float32), "label": label,
            "weight": (0.5 + r.random((b, S, S, S))).astype(np.float32)}


def _snapshot(state) -> dict:
    return {"params": [t.detach().clone() for t in _leaves(state.params)],
            "moments": [{k: v.clone() for k, v in state.optimizer.state[t].items()}
                        for t in _leaves(state.params) if t in state.optimizer.state],
            "step": state.step}


def _steps(mesh, tree, sizes, remat=False):
    """Stage-2 steps on batches of `sizes` from one seeded generator's
    draws, on a rank of `mesh` or (mesh None) in this process; the last
    step's aux and gradients and the final state."""
    state = create_train_state(tree, make_optimizer()[0])
    step = make_train_step(SEUNetConfig(remat=remat), stage=2, mesh=mesh)
    g = torch.Generator().manual_seed(9)
    for i, b in enumerate(sizes):
        batch = _batch(b, seed=4 + i)
        if mesh is None:
            batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        state, aux = step(state, batch, g)
    return {"aux": aux, "grads": [None if t.grad is None else t.grad.clone()
                                  for t in _leaves(state.params)], **_snapshot(state)}


def _oom_rank(mesh, tree):
    """make_resilient_step with an out-of-memory error injected in rank 1's
    first forward, then in rank 0's second forward of the rebuilt step
    (the step after the retry)."""
    built, calls = [], {}
    apply_fast = pstep.apply_fast

    def make(cfg, stage, mesh, shard_space, fast):
        built.append(cfg.remat)
        k = len(built)

        def forward(*a, **kw):
            calls[k] = calls.get(k, 0) + 1
            if (mesh.rank, k, calls[k]) in ((1, 1, 1), (0, 2, 2)):
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
            return apply_fast(*a, **kw)
        with mock.patch.object(pstep, "apply_fast", forward):
            return make_train_step(cfg, stage, mesh, shard_space, fast)

    state = create_train_state(tree, make_optimizer()[0])
    step = make_resilient_step(SEUNetConfig(), stage=2, mesh=mesh, _make_step=make)
    # the draws `_steps` takes from its generator first; the retry reuses them
    draws = draw_dropout(4, SEUNetConfig(), torch.Generator().manual_seed(9))
    state, _ = step(state, _batch(4), drop_draws=draws)
    out = {"built": list(built), "fellback": step.fallback_active(), **_snapshot(state)}
    try:
        step(state, _batch(4, seed=5), torch.Generator().manual_seed(10))
    except torch.cuda.OutOfMemoryError as e:
        out["second"] = str(e)
    out["after_second"] = _snapshot(state)["params"]
    return out


def _error_rank(mesh, tree):
    """make_resilient_step with a ValueError raised in rank 1's forward:
    what each rank raised, whether it fell back, and its parameters."""
    apply_fast = pstep.apply_fast

    def make(cfg, stage, mesh, shard_space, fast):
        def forward(*a, **kw):
            if mesh.rank == 1:
                raise ValueError("a bad batch (injected)")
            return apply_fast(*a, **kw)
        with mock.patch.object(pstep, "apply_fast", forward):
            return make_train_step(cfg, stage, mesh, shard_space, fast)

    state = create_train_state(tree, make_optimizer()[0])
    step = make_resilient_step(SEUNetConfig(), stage=2, mesh=mesh, _make_step=make)
    try:
        step(state, _batch(4), torch.Generator().manual_seed(9))
        raised = None
    except Exception as e:
        raised = (type(e).__name__, str(e))
    return {"raised": raised, "fellback": step.fallback_active(), **_snapshot(state)}


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh2_rank(mesh):
    """`make_mesh(n_space=2)` over the same 2 ranks: its axes, and the
    layout of a (2, 4, 1) batch with and without `shard_space`."""
    m = make_mesh(n_space=2, devices=["cpu", "cpu"])
    x = np.arange(8).reshape(2, 4, 1)
    return {"shape": m.shape, "ranks": (m.data_rank, m.space_rank),
            "slab": batch_sharding(m, shard_space=True)(x), "rows": batch_sharding(m)(x)}


def _step_runs(mesh, tree, bench_ctx):
    """On every rank: one sharded step (B=4), three replicated ones (B=3,
    1, 3), the out-of-memory run with its remat=True reference, a (1, 2)
    mesh, and last the benchmark's four-card driver on these 2 ranks (in
    this spawn, not one of its own, to spare the ranks' start-up)."""
    return {"sharded": _steps(mesh, tree, [4]), "replicated": _steps(mesh, tree, [3, 1, 3]),
            "oom": _oom_rank(mesh, tree), "remat": _steps(mesh, tree, [4], True),
            "error": _error_rank(mesh, tree), "mesh2": _mesh2_rank(mesh),
            "bench": train_stage1_dp.rank_steps(mesh, bench_ctx)}


@pytest.fixture(scope="module")
def step_runs(one_thread):
    tree = _tree()
    ranks = spawn(_step_runs, 2, tree, _bench_ctx(), timeout_s=TIMEOUT_S)
    one = {"sharded": _steps(None, _tree_map(torch.clone, tree), [4]),
           "replicated": _steps(None, _tree_map(torch.clone, tree), [3, 1, 3])}
    return ranks, one


def test_sharded_step_matches_one_process(step_runs):
    ranks, one = step_runs
    got, one = [r["sharded"] for r in ranks], one["sharded"]
    for k, v in one["aux"].items():
        np.testing.assert_allclose(got[0]["aux"][k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    big = max(float(g.norm()) for g in one["grads"] if g is not None)
    for g, ref in zip(got[0]["grads"], one["grads"]):
        assert (g is None) == (ref is None)
        if ref is not None and float(ref.norm()) > 1e-5 * big:
            assert float((g - ref).norm()) <= LEAF_RTOL * float(ref.norm())
    for a, b in zip(got[0]["params"], got[1]["params"]):
        assert torch.equal(a, b)


def test_replicated_batches_keep_the_ranks_bitwise_equal(step_runs):
    ranks, one = step_runs
    one = one["replicated"]
    for r in ranks:
        r = r["replicated"]
        assert r["step"] == 3
        for got, want in ((r["params"], one["params"]), (r["moments"], one["moments"])):
            for a, b in zip(got, want):
                if isinstance(a, dict):
                    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
                else:
                    assert torch.equal(a, b)


def test_out_of_memory_on_one_rank_falls_back_on_every_rank(step_runs):
    ranks, _ = step_runs
    for r in ranks:
        oom, want = r["oom"], r["remat"]
        assert oom["built"] == [False, True] and oom["fellback"] and oom["step"] == 1
        # the retry started from the unchanged parameters: the remat
        # step's result, bitwise
        for a, b in zip(oom["params"], want["params"]):
            assert torch.equal(a, b)
        assert "out of device memory" in oom["second"]
        for a, b in zip(oom["after_second"], oom["params"]):
            assert torch.equal(a, b)


def test_an_error_on_one_rank_raises_on_every_rank(step_runs):
    """A ValueError in rank 1's forward: rank 1 raises it, rank 0 a
    RuntimeError naming the failed rank, both before AdamW (the parameters
    unchanged, no step counted) and neither falls back to remat."""
    ranks, _ = step_runs
    tree = _tree()
    assert ranks[1]["error"]["raised"] == ("ValueError", "a bad batch (injected)")
    assert ranks[0]["error"]["raised"][0] == "RuntimeError"
    assert "1 of 2 ranks failed" in ranks[0]["error"]["raised"][1]
    for r in ranks:
        assert not r["error"]["fellback"] and r["error"]["step"] == 0
        for a, b in zip(r["error"]["params"], _leaves(tree)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("bucket,sizes", [(True, [2] * 5 + [1]), (False, [1] * 11)])
def test_replay_buckets_on_a_mesh(bucket, sizes):
    """`_replay_pass` over 11 cached crops on rank 0 of 2 (JAX
    tests/test_resilience.py:156-227): every crop once, in order, in
    buckets of 2 and a B=1 tail with `replay_bucket`, else one by one."""
    mesh = DataMesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    cfg = pstages.StageConfig(data_root="", file_root="", file_path="", model_savepath="",
                              log_savepath="", epochs=1, mesh=mesh, replay_bucket=bucket)
    items = [{"name": f"c{i}", "image": np.full((S, S, S, 2), i, np.float32)}
             for i in range(11)]
    seen = []

    def step(state, batch, **draws):
        seen.append(batch["image"][:, 0, 0, 0, 0].tolist())
        return state, {}
    pstages._replay_pass(cfg, None, items, step, pstages.Draws(0, "cpu"), "cpu")
    assert [len(b) for b in seen] == sizes
    assert sum(seen, []) == list(range(11))


def test_loss_sums_add_over_shards():
    """Dice, GUL and atr as ratios of sums: the same values as the
    whole-batch formulas they replaced (bitwise), and the shards' sums add
    up to the whole batch's."""
    r = np.random.default_rng(6)
    p, t, w = (torch.from_numpy(r.random((4, 8, 8, 8)).astype(np.float32)) for _ in range(3))
    t = (t > 0.6).float()
    flat = [x.reshape(-1) for x in (p, t, w)]
    fp, ft, fw = flat
    dice = 1.0 - (2.0 * torch.sum(fp * ft) + 1.0) / (torch.sum(fp) + torch.sum(ft) + 1.0)
    wi = ft * 1e-4 + (1.0 - ft) * 1e-4
    gul = 1.0 - (torch.sum(fw * ((fp + wi) ** 0.7) * ft) + 1.0) / (
        torch.sum(fw * (0.2 * fp + 0.8 * ft)) + 1.0)
    ps = fp * ft
    atr = 1.0 - (torch.sum(fw * ps * ft) + 1.0) / (torch.sum(fw * (ps + ft)) + 1.0)
    assert torch.equal(losses.dice_loss(p, t), dice)
    assert torch.equal(losses.general_union_loss(p, t, w), gul)
    assert torch.equal(losses.atr_loss(p, t, w), atr)
    for sums, ratio, args in ((losses.dice_sums, losses.dice_from_sums, (p, t)),
                              (losses.general_union_sums, losses.union_from_sums, (p, t, w)),
                              (losses.atr_sums, losses.union_from_sums, (p, t, w))):
        whole = torch.stack(sums(*args))
        shards = sum(torch.stack(sums(*(a[i:i + 2] for a in args))) for i in (0, 2))
        torch.testing.assert_close(shards, whole, rtol=1e-6, atol=0)
        torch.testing.assert_close(ratio(shards.unbind()), ratio(whole.unbind()), rtol=1e-6,
                                   atol=0)


# ---- the drivers ------------------------------------------------------


def _write_env(root, n_train: int = N_TRAIN, n_val: int = 1) -> dict:
    """AFTER_DATA of tube cases of 32^3 (by default 4 train, 1 val), pred_1
    (the upper half of each airway) and the port's LIB weights, skeletons
    and parses."""
    data_dir, mask_dir = root / "AFTER_DATA" / "data", root / "AFTER_DATA" / "mask"
    file_root = root / "data"
    for d in (data_dir, mask_dir, file_root / "pred_1"):
        os.makedirs(d)
    rng = np.random.default_rng(0)
    names = [f"CASE{i:03d}" for i in range(n_train + n_val)]
    for n in names:
        hu = rng.normal(30, 10, (SIDE,) * 3).astype(np.float32)
        mask = np.zeros((SIDE,) * 3, np.uint8)
        mask[14:17, 14:17, 4:28] = 1
        mask[14:17, 17:26, 14:17] = 1
        hu[mask == 1] = -950
        write_nifti(str(data_dir / f"{n}data_cut.nii.gz"), (hu + 1024).astype(np.int16))
        write_nifti(str(mask_dir / f"{n}mask_cut.nii.gz"), mask)
        write_nifti(str(file_root / "pred_1" / f"{n}.nii.gz"),
                    (mask * (np.arange(SIDE) < SIDE // 2)[None, None, :]).astype(np.uint8))
    with open(file_root / "base_dict.json", "w") as f:
        json.dump({"0": {"train": names[:n_train], "val": names[n_train:]}}, f)
    save_lib_weights(str(mask_dir), str(file_root / "LIB_weight"), device="cpu")
    for split, suffix in (("train", ""), ("val", "_val")):
        save_skeletons_and_parses(str(mask_dir), str(file_root / "base_dict.json"),
                                  str(file_root / f"tree_parse{suffix}"),
                                  str(file_root / f"skeleton{suffix}"), split=split)
    return {"data_root": str(root / "AFTER_DATA"), "file_root": str(file_root),
            "file_path": str(file_root / "base_dict.json")}


def _stage_cfg(env: dict, out: str, stage: int, epochs: int, mesh, **kw):
    extra = {} if stage == 1 else {
        "milestones": (40, 60), "pred_path": os.path.join(env["file_root"], "pred_1"),
        "online_savepath": os.path.join(out, "online")}
    return pstages.StageConfig(
        data_root=env["data_root"], file_root=env["file_root"], file_path=env["file_path"],
        model_savepath=os.path.join(out, "model"), log_savepath=os.path.join(out, "LOG.txt"),
        epochs=epochs, batch_size=BATCH, cube=CUBE, seed=7, start_params=_tree(), mesh=mesh,
        device="cpu", **extra, **kw)


def _drive(mesh, env: dict, out: str, stage: int, epochs: int, **kw) -> dict:
    """One driver run; per step (batch size, loss, state.step before it),
    the calls that write files and the final parameters."""
    rec = {"steps": [], "writes": {"params": 0, "resume_point": 0, "cache": 0}}
    make, save_params = pstages.make_resilient_step, pstages.save_params
    save_point, add_batch = pstages._save_resume_point, pstages.OnlineCache.add_batch

    def recorded(*a, **k):
        step = make(*a, **k)

        def run(state, batch, **draws):
            before = state.step
            state, aux = step(state, batch, **draws)
            rec["steps"].append((batch["image"].shape[0], float(aux["loss"]), before))
            return state, aux
        return run

    def counting(name, fn):
        def call(*a, **k):
            rec["writes"][name] += 1
            return fn(*a, **k)
        return call

    with mock.patch.multiple(pstages, make_resilient_step=recorded,
                             save_params=counting("params", save_params),
                             _save_resume_point=counting("resume_point", save_point)), \
            mock.patch.object(pstages.OnlineCache, "add_batch", counting("cache", add_batch)):
        train = pstages.train_stage1 if stage == 1 else pstages.train_stage2
        state = train(_stage_cfg(env, out, stage, epochs, mesh, **kw))
    rec["params"] = _tree_map(lambda t: t.detach().clone(), state.params)
    return rec


def _drivers_rank(mesh, env: dict, root: str) -> dict:
    """The mesh's driver runs, one after the other, on every rank."""
    return {
        "stage2": _drive(mesh, env, os.path.join(root, "s2"), 2, 1),
        "stage2_resume": _drive(mesh, env, os.path.join(root, "s2"), 2, 2, replay_bucket=True),
        "stage1": _drive(mesh, env, os.path.join(root, "s1"), 1, 1),
    }


@pytest.fixture(scope="module")
def drivers(tmp_path_factory, one_thread):
    root = tmp_path_factory.mktemp("parallel_drivers")
    env = _write_env(root)
    ranks = spawn(_drivers_rank, 2, env, str(root / "mesh"), timeout_s=TIMEOUT_S)
    one = {"stage2": _drive(None, env, str(root / "one" / "s2"), 2, 1),
           "stage1": _drive(None, env, str(root / "one" / "s1"), 1, 1)}
    return ranks, one, root


def _same_on_every_rank(ranks, run):
    """The global losses on every rank, the same final parameters, and
    rank 1 wrote nothing."""
    for r in ranks[1:]:
        assert r[run]["steps"] == ranks[0][run]["steps"]
        for a, b in zip(_leaves(r[run]["params"]), _leaves(ranks[0][run]["params"])):
            assert torch.equal(a, b)
        assert r[run]["writes"] == {"params": 0, "resume_point": 0, "cache": 0}


@pytest.mark.parametrize("run", ["stage2", "stage1"])
def test_drivers_on_a_mesh_match_one_process(drivers, run):
    ranks, one, root = drivers
    got, ref = ranks[0][run], one[run]
    assert [s[0] for s in got["steps"]] == [s[0] for s in ref["steps"]] == \
        [BATCH] * N_TRAIN + ([1, 1] if run == "stage2" else [])
    for a, b in zip(got["steps"], ref["steps"]):
        np.testing.assert_allclose(a[1], b[1], rtol=LOSS_RTOL)
    _same_on_every_rank(ranks, run)
    assert got["writes"] == ref["writes"]  # rank 0 writes what one process writes
    out = root / "mesh" / run.replace("stage", "s")
    if run == "stage1":  # stage 2's directory is resumed below
        assert sorted(os.listdir(out / "model")) == sorted(
            os.listdir(root / "one" / "s1" / "model"))
    saved = load_params(str(out / "model" / "SE_UNet_0.pt"))
    for a, b in zip(_leaves(saved), _leaves(got["params"])):
        assert torch.equal(a, b)
    assert os.path.exists(out / "LOG.txt")


def test_a_resumed_driver_on_a_mesh_with_replay_buckets(drivers):
    """train_stage2 for 2 epochs on the directory of the 1-epoch run, with
    `replay_bucket`: it runs epoch 1 alone, from the step count epoch 0
    ended at, and replays the cache's 2 crops in one sharded step."""
    ranks, _, root = drivers
    first, got = ranks[0]["stage2"]["steps"], ranks[0]["stage2_resume"]
    assert got["steps"][0][2] == len(first)
    assert [s[0] for s in got["steps"]] == [BATCH] * N_TRAIN + [2]
    assert got["writes"] == {"params": 1, "resume_point": 1, "cache": N_TRAIN}
    _same_on_every_rank(ranks, "stage2_resume")
    model = root / "mesh" / "s2" / "model"
    assert sorted(os.listdir(model)) == [
        "SE_UNet_0.pt", "SE_UNet_1.pt", "resume_meta.json", "state_0.pt", "state_1.pt"]
    for a, b in zip(_leaves(load_params(str(model / "SE_UNet_1.pt"))), _leaves(got["params"])):
        assert torch.equal(a, b)


def test_space_axis_and_non_meshes_raise(step_runs):
    """make_mesh(n_space=2) builds the (1, 2) mesh (rank = d * 2 + s) and
    batch_sharding(shard_space=True) gives each rank its depth slab; what
    still raises: conv_stats / conv_epi on a depth slab (ROADMAP M9b),
    shard_space without a mesh, and objects that are not a mesh."""
    ranks, _ = step_runs
    x = np.arange(8).reshape(2, 4, 1)
    for r, got in enumerate(ranks):
        m = got["mesh2"]
        assert m["shape"] == {"data": 1, "space": 2} and m["ranks"] == (0, r)
        np.testing.assert_array_equal(m["slab"], x[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(m["rows"], x)
    space = DataMesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo", space_size=2)
    for field in ("conv_stats", "conv_epi"):
        cfg = SEUNetConfig(**{field: True})
        with pytest.raises(NotImplementedError, match="M9b"):
            apply_fast(_tree(), torch.zeros((1, 8, 16, 16, 2)), cfg=cfg, space=space)
    with pytest.raises(ValueError, match="shard_space"):
        make_train_step(SEUNetConfig(), shard_space=True)
    with pytest.raises(TypeError, match="DataMesh"):
        batch_sharding(object(), shard_space=True)
    for build in (lambda: make_train_step(SEUNetConfig(), mesh=object()),
                  lambda: batch_sharding(object()),
                  lambda: SlidingWindowRunner(_tree(), SEUNetConfig(), mesh=object(),
                                              device="cpu")):
        with pytest.raises(TypeError, match="DataMesh"):
            build()


def _bench_ctx() -> harness.Context:
    """The four-card cell's context at a tiny size: SE-UNet in float32,
    16^3 crops from two small phantom cases, 2 ranks with 1 crop each."""
    root = Path(__file__).resolve().parents[1] / "portbench"
    config = json.loads((root / "configs/seunet-bf16.json").read_text())
    config.update(compute_dtype="float32", remat=False)
    mix = json.loads((root / "traffic/stage1_resident_dp4.json").read_text())
    mix.update(cases=[[24, 24, 24], [24, 16, 24]], pool=4, batch=2, ranks=2, cube=16,
               warmup_steps=0)
    limits = json.loads((root / "checks/train-bf16-s1-dp4.json").read_text())
    return harness.Context(workload="train-bf16-s1-dp4", seed=2**33 + 5, seconds=0.05,
                           trace=False, config=config, mix=mix, limits=limits,
                           t0=time.perf_counter(), device="cpu")


def test_benchmark_rank_steps_on_two_ranks(step_runs):
    ranks, _ = step_runs
    out = [r["bench"] for r in ranks]
    assert len(out) == _bench_ctx().mix["ranks"] and out[1] is None
    checks = {c.name: c for c in out[0].checks}
    assert set(checks) == {"loss_gap", "grad_gap_vs_bf16", "change_gap_median",
                           "rank_param_diff"}
    assert checks["rank_param_diff"].value == 0.0
    assert all(c.ok for c in checks.values()), checks
    rec = out[0].record
    assert rec.work["steps"] >= 1 and rec.work["crops"] == 2 * rec.work["steps"]
    assert rec.work["ranks"] == 2 and rec.window_s > 0
