"""The port's spans and counters (`utils.profiling`) on the CPU: off
without a profiler session; under one, the record's parents, threads and
clock against the profiler's own trace; `device_trace` writing a plain
thread's spans into its file; and the spans of the data layer, the runner,
the step's upload and the mesh step's collectives (on a 1-rank gloo group
in this process) where the program places them."""

import json
import os
import statistics
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from se_unet_airseg_tpu_torch.data import Prefetcher, Stage1Crops
from se_unet_airseg_tpu_torch.infer import SlidingWindowRunner
from se_unet_airseg_tpu_torch.infer.sliding_window import fetch_trits
from se_unet_airseg_tpu_torch.io import write_nifti
from se_unet_airseg_tpu_torch.models import SEUNet, SEUNetConfig
from se_unet_airseg_tpu_torch.parallel import make_mesh
from se_unet_airseg_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_train_step,
    stages,
)
from se_unet_airseg_tpu_torch.utils import profiling
from se_unet_airseg_tpu_torch.utils.profiling import count, span

from test_torch_sliding_window import torch_threads  # noqa: F401


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _children(rec, i) -> list:
    return [s.name for s in rec.spans if s.parent == i]


def _worker(out: dict, name: str = "worker.part"):
    def run():
        out["tid"] = threading.get_native_id()
        with span(name):
            time.sleep(0.002)
    return threading.Thread(target=run)


def test_off_without_a_session_records_nothing(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("a span without a session opened a range")

    before = profiling.record()
    monkeypatch.setattr(profiling, "record_function", fail)
    monkeypatch.setattr(profiling, "_On", fail)
    assert span("a") is span("b")
    with span("data.read"):
        with span("data.augment"):
            pass
    count("train.h2d_bytes", 10)
    assert profiling.record() == before


def test_nested_spans_and_a_second_thread():
    out = {}
    with _cpu_profile():
        with span("outer"):
            with span("inner"):
                t = _worker(out)
                t.start()
                t.join()
        count("bytes", 3)
        count("bytes", 4)
    rec = profiling.record()
    names = [s.name for s in rec.spans]
    assert sorted(names) == ["inner", "outer", "worker.part"]
    outer, inner, part = (rec.spans[names.index(n)] for n in ("outer", "inner", "worker.part"))
    assert outer.parent is None and rec.spans[inner.parent] == outer
    assert part.parent is None and part.thread == out["tid"] != outer.thread
    assert outer.mirrored and inner.mirrored and not part.mirrored
    assert outer.start_ns <= inner.start_ns <= part.start_ns <= part.end_ns <= outer.end_ns
    assert rec.counts == {"bytes": 7}


def test_record_on_the_trace_clock(tmp_path):
    with record_function("warm-up"):
        pass
    # no other Python thread (the test runner's own) takes the GIL between a
    # span's stamp and its range's end
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1.0)
    out = {}
    try:
        with _cpu_profile() as prof:
            for _ in range(3):
                with span("outer"):
                    t = _worker(out)
                    t.start()
                    t.join()
    finally:
        sys.setswitchinterval(interval)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    rec = profiling.record()
    base = trace["baseTimeNanoseconds"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
                    if e.get("ph") == "X" and e["name"] == "outer")
    mine = [s for s in rec.spans if s.name == "outer"]
    parts = [s for s in rec.spans if s.name == "worker.part"]
    assert len(ranges) == len(mine) == len(parts) == 3
    gaps = []
    for (a, b), s, p in zip(ranges, mine, parts):
        s0, s1 = (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3
        # stamped after its range opens and before it closes: inside it
        assert a - 50 <= s0 <= s1 <= b + 50
        gaps += [s0 - a, b - s1]
        assert a <= (p.start_ns - base) / 1e3 <= (p.end_ns - base) / 1e3 <= b
    # and on its clock: the edges agree within 100 µs (the median edge, since
    # a thread the OS preempts between the two stamps widens one edge)
    assert statistics.median(gaps) < 100


def test_device_trace_writes_a_plain_threads_spans(tmp_path):
    out = {}
    with profiling.device_trace(str(tmp_path / "trace")):
        with span("outer"):
            t = _worker(out)
            t.start()
            t.join()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    part = [e for e in events if e.get("name") == "worker.part"]
    assert len(part) == 1 and part[0]["tid"] == out["tid"] and part[0]["dur"] > 0
    assert [e for e in events if e.get("ph") == "M" and e.get("tid") == out["tid"]]
    assert len([e for e in events if e.get("name") == "outer"]) == 1


def _write_cases(root, names, side=24):
    rng = np.random.default_rng(0)
    for d in ("data", "mask", "LIB_weight"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for name in names:
        hu = rng.integers(0, 2048, (side,) * 3).astype(np.int16)
        mask = (rng.random((side,) * 3) < 0.2).astype(np.uint8)
        write_nifti(os.path.join(root, "data", name + "data_cut.nii.gz"), hu)
        write_nifti(os.path.join(root, "mask", name + "mask_cut.nii.gz"), mask)
        np.save(os.path.join(root, "LIB_weight", name + ".npy"),
                rng.random((side,) * 3).astype(np.float16))
    split = os.path.join(root, "split.json")
    with open(split, "w") as f:
        json.dump({"0": {"train": list(names)}}, f)
    return split


def test_prefetcher_batches_carry_their_parts(tmp_path):
    split = _write_cases(str(tmp_path), ["case00", "case01"])
    ds = Stage1Crops(split, str(tmp_path), str(tmp_path), batch_size=2, cube=16, seed=3)
    with _cpu_profile():
        got = list(Prefetcher(ds))
    rec = profiling.record()
    batches = [i for i, s in enumerate(rec.spans) if s.name == "data.batch"]
    assert len(batches) == len(got) == 2
    for i in batches:
        kids = _children(rec, i)
        assert sorted(set(kids)) == ["data.augment", "data.finalize", "data.read"]
        assert kids.count("data.read") == 2  # the volume, the LIB weight
        assert kids.count("data.augment") == 2 and kids.count("data.finalize") == 3
        assert not rec.spans[i].mirrored and rec.spans[i].thread_name == "Prefetcher"
    waits = [s for s in rec.spans if s.name == "data.wait"]
    assert len(waits) == 3 and all(s.mirrored for s in waits)  # two batches, the end


@pytest.fixture(scope="module")
def small_runner():
    torch.manual_seed(0)
    return SlidingWindowRunner(SEUNet(SEUNetConfig()), SEUNetConfig(), cube=16, step=8,
                               batch=1, device="cpu")


def test_runner_spans_a_volume(small_runner):
    vol = np.random.default_rng(1).integers(0, 2048, (24, 16, 16)).astype(np.int16)
    with _cpu_profile():
        out = small_runner.predict_trits_summary_device(vol, hu_shift=-1024.0)
        trits = fetch_trits(out)
    rec = profiling.record()
    names = [s.name for s in rec.spans if not s.name.startswith("norm.")]
    assert trits.shape == vol.shape
    assert names.count("runner.volume") == 1 and names.count("runner.prep") == 1
    assert names.count("runner.tile_batch") == 2  # 2 tiles at batch 1
    assert names.count("runner.fetch") == names.count("runner.decode") == 1
    vol_i = next(i for i, s in enumerate(rec.spans) if s.name == "runner.volume")
    assert {"runner.prep", "runner.tile_batch"} <= set(_children(rec, vol_i))
    fetch_i = next(i for i, s in enumerate(rec.spans) if s.name == "runner.fetch")
    assert _children(rec, fetch_i) == ["runner.decode"]
    tile_i = next(i for i, s in enumerate(rec.spans) if s.name == "runner.tile_batch")
    assert "norm.stats" in _children(rec, tile_i)
    # the overlap count is built for every volume, the same shape again too
    assert names.count("runner.inv_count") == 1
    assert _children(rec, vol_i).count("runner.inv_count") == 1
    with _cpu_profile():
        small_runner.predict_trits_summary_device(vol, hu_shift=-1024.0)
    again = profiling.record()
    vol_i = next(i for i, s in enumerate(again.spans) if s.name == "runner.volume")
    assert [s.name for s in again.spans].count("runner.inv_count") == 1
    assert _children(again, vol_i).count("runner.inv_count") == 1


def test_epoch_pass_counts_the_uploaded_bytes():
    rng = np.random.default_rng(2)
    batches = [{"image": rng.random((2, 8, 8, 8, 2), np.float32),
                "label": rng.random((2, 8, 8, 8)).astype(np.float32),
                "weight": rng.random((2, 8, 8, 8)).astype(np.float32), "name": f"c{i}"}
               for i in range(3)]
    want = sum(v.nbytes for b in batches for k, v in b.items() if k != "name")

    def step(state, batch, **kw):
        return state, {"loss": torch.zeros(())}

    with _cpu_profile():
        stages._epoch_pass(None, step, batches, stages.Draws(0, "cpu"), torch.device("cpu"),
                           log_every=10**9)
    rec = profiling.record()
    assert rec.counts == {"train.h2d_bytes": want}
    assert [s.name for s in rec.spans] == ["train.upload"] * 3


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_mesh(n_data=1, devices=["cpu"])
    finally:
        dist.destroy_process_group()


def test_mesh_step_spans(one_rank):
    """The sharded step under a profiler session: `train.upload` in
    `step.place`, `mesh.loss_sum` and `mesh.grad_reduce` once each a step,
    `train.h2d_bytes` the batch's bytes; nothing without a session."""
    tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(3)).params_tree()
    state = create_train_state(tree, make_optimizer()[0])
    step = make_train_step(SEUNetConfig(), stage=1, mesh=one_rank)
    r = np.random.default_rng(0)
    batch = {"image": r.random((1, 16, 16, 16, 2), dtype=np.float32),
             "label": (r.random((1, 16, 16, 16)) > 0.7).astype(np.float32),
             "weight": np.ones((1, 16, 16, 16), np.float32)}
    gen = torch.Generator().manual_seed(1)
    before = profiling.record()
    step(state, batch, gen)
    assert profiling.record() == before
    with _cpu_profile():
        step(state, batch, gen)
    rec = profiling.record()
    names = [s.name for s in rec.spans]
    assert [n for n in names if n.startswith(("mesh.", "train."))] == [
        "train.upload", "mesh.loss_sum", "mesh.grad_reduce"]
    assert rec.counts == {"train.h2d_bytes": sum(v.nbytes for v in batch.values())}
