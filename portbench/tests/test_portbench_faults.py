"""A run with the timed path broken underneath comes out not correct, and a
sound one correct: the drivers on the CPU at a small size, in float32,
judged by each cell's own limits. One case for each fault a cell can have
on one chip: a volume's answer altered where it is produced; a step that
leaves the state unchanged; half of each batch left out, the loss taken
over the rest; a crop altered where the data layer makes it."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import harness, program

ROOT = Path(__file__).resolve().parents[2]
TINY_INFER = dict(shapes=[[48, 40, 56], [40, 40, 48]], volumes=2, cube=32, step=16, batch=2,
                  warmup=[0], trace_volumes=[1], check_volumes=2)
TINY_TRAIN = dict(cases=[[48, 40, 56], [40, 48, 40]], cube=32, batch=2, pool=4)
REAL_STEP = program.make_resilient_step


def _run(workload: str, tiny: dict, tmp_path) -> harness.Outcome:
    bench = harness.load_bench()
    work, conf = harness.cell(bench, workload)
    config = json.loads((ROOT / conf["file"]).read_text())
    config["compute_dtype"] = "float32"  # the CPU's sound run reads near 0
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{work['traffic']}.json").read_text())
    mix.update(tiny)
    ctx = harness.Context(
        workload=workload, seed=2**31 + 7, seconds=0.2, trace=False, config=config, mix=mix,
        limits=json.loads((ROOT / "portbench" / "checks" / f"{workload}.json").read_text()),
        t0=time.perf_counter(), device="cpu", scratch=str(tmp_path))
    return harness.driver(mix["driver"]).run(ctx)


def _correct(out: harness.Outcome) -> bool:
    return harness.result_line(out, {}, {}, False)["correct"]


def test_sound_inference_run_is_correct(tmp_path):
    assert _correct(_run("infer-bf16-lungbox", TINY_INFER, tmp_path))


def test_an_altered_answer_is_not_correct(tmp_path, monkeypatch):
    real = program.SlidingWindowRunner.predict_trits

    def altered(self, vol, **kw):
        trits = real(self, vol, **kw).copy()
        trits[:16, :16, :16] = (trits[:16, :16, :16] + 1) % 3
        return trits

    monkeypatch.setattr(program.SlidingWindowRunner, "predict_trits", altered)
    out = _run("infer-bf16-lungbox", TINY_INFER, tmp_path)
    assert not _correct(out) and out.checks[0].value > out.checks[0].limit


@pytest.mark.parametrize("workload", ["train-bf16-s1-resident", "train-bf16-s1-disk"])
def test_sound_training_run_is_correct(tmp_path, workload):
    out = _run(workload, TINY_TRAIN, tmp_path)
    assert _correct(out), [(c.name, c.value, c.limit) for c in out.checks]


def _unchanged(cfg, stage=1):
    from se_unet_airseg_tpu_torch.train.step import make_loss_fn

    loss_fn = make_loss_fn(cfg, stage)

    def step(state, batch, rng=None, *, drop_draws=None):
        loss, aux = loss_fn(state.params, batch, rng, drop_draws)
        return state, {k: v.detach() for k, v in aux.items()}

    return step


def _half_batch(cfg, stage=1):
    real = REAL_STEP(cfg, stage=stage)

    def step(state, batch, rng=None, *, drop_draws=None):
        half = batch["image"].shape[0] // 2
        return real(state, {k: v[:half] for k, v in batch.items()},
                    drop_draws=[d[:half] for d in drop_draws])

    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(program, "make_resilient_step", fault)
    out = _run("train-bf16-s1-resident", TINY_TRAIN, tmp_path)
    assert not _correct(out)
    failed = {c.name for c in out.checks if not c.ok}
    assert failed & {"grad_gap_vs_bf16", "change_gap_median", "loss_gap"}


def test_an_altered_crop_is_not_correct(tmp_path, monkeypatch):
    from se_unet_airseg_tpu_torch.data.datasets import Stage1Crops

    real = Stage1Crops.sample_volume

    def altered(self, name):
        batch = real(self, name)
        batch["image"] = batch["image"] + np.float32(1e-3)
        return batch

    monkeypatch.setattr(Stage1Crops, "sample_volume", altered)
    out = _run("train-bf16-s1-disk", TINY_TRAIN, tmp_path)
    assert not _correct(out)
    assert {c.name for c in out.checks if not c.ok} >= {"batch_max_diff"}
