"""The port's small entry points against the JAX package's, on the CPU:
the data-preparation CLIs (`cli.preprocess`, `cli.write_json`: equal
files), the profiling helpers (`Timer`, `time_report`: equal reports;
`device_trace`: a Chrome trace), and `entry()`, the compile-check entry
point (the bf16 fast forward at 128^3, batch 1; `cuda` unless the CPU
is asked for)."""

import json
import os
import time

import numpy as np
import pytest
import torch

from se_unet_airseg_tpu.cli import preprocess as jprep_cli
from se_unet_airseg_tpu.cli import write_json as jjson_cli
from se_unet_airseg_tpu.io import read_nifti, write_nifti
from se_unet_airseg_tpu.utils import profiling as jprof
from se_unet_airseg_tpu_torch.cli import preprocess as pprep_cli
from se_unet_airseg_tpu_torch.cli import write_json as pjson_cli
from se_unet_airseg_tpu_torch.entry import entry
from se_unet_airseg_tpu_torch import utils as putils
from se_unet_airseg_tpu_torch.utils import devices as pdev
from se_unet_airseg_tpu_torch.utils import profiling as pprof

from test_cli_entrypoints import _raw_case
from test_torch_sliding_window import torch_threads  # noqa: F401


def test_preprocess_and_write_json_clis_match_jax(tmp_path):
    raw = tmp_path / "BEFORE_DATA"
    for d in ("data", "mask"):
        os.makedirs(raw / d)
    rng = np.random.default_rng(0)
    for i in range(2):
        write_nifti(str(raw / "data" / f"CASE00{i}.nii.gz"), _raw_case(rng).astype(np.int16))
        mask = np.zeros((96, 96, 48), np.uint8)
        mask[20 + i:40, 20:26, 10:40] = 1
        write_nifti(str(raw / "mask" / f"CASE00{i}.nii.gz"), mask)
    for name, mod in (("port", pprep_cli), ("jax", jprep_cli)):
        out = tmp_path / name
        mod.main(["--input_data", str(raw / "data"), "--output_data", str(out / "data"),
                  "--input_mask", str(raw / "mask"), "--output_mask", str(out / "mask")])
    for d in ("data", "mask"):
        files = sorted(os.listdir(tmp_path / "port" / d))
        assert files == sorted(os.listdir(tmp_path / "jax" / d)) and files
        for f in files:
            a, b = tmp_path / "port" / d / f, tmp_path / "jax" / d / f
            if f.endswith(".npy"):
                np.testing.assert_array_equal(np.load(a), np.load(b))
            else:
                va, vb = read_nifti(str(a)), read_nifti(str(b))
                np.testing.assert_array_equal(va.array, vb.array)
                assert va.array.dtype == vb.array.dtype and va.spacing == vb.spacing

    for name, mod in (("port", pjson_cli), ("jax", jjson_cli)):
        mod.main(["--mask_dir", str(tmp_path / "jax" / "mask"), "--out_dir",
                  str(tmp_path / f"{name}_split"), "--n_train", "1", "--seed", "3"])
    for f in ("base_dict.json", "test.json"):
        got = json.loads((tmp_path / "port_split" / f).read_text())
        assert got == json.loads((tmp_path / "jax_split" / f).read_text())


def test_profiling_helpers_match_jax(tmp_path):
    lines = {"Centerline segment time": 12.7, "Airway tree parse time": 3.2,
             "Number of branches": 41}
    pprof.time_report(str(tmp_path / "port.txt"), lines)
    jprof.time_report(str(tmp_path / "jax.txt"), lines)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    with pprof.Timer() as t:
        time.sleep(0.01)
        first = t.lap("a")
        t.lap("b")
        t.lap("a")
    assert list(t.laps) == ["a", "b"] and first >= 0.01 and t.laps["a"] >= first
    with pprof.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_utils_exports_the_jax_names():
    assert {"Timer", "time_report", "device_trace", "pick_devices",
            "device_summary", "resolve_device"} <= set(putils.__all__)
    assert putils.Timer is pprof.Timer and putils.device_trace is pprof.device_trace


def _fake_cards(monkeypatch, free_gb):
    """torch.cuda as a machine of len(free_gb) 80 GB cards with those GB
    free."""
    monkeypatch.setattr(pdev.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pdev.torch.cuda, "device_count", lambda: len(free_gb))
    monkeypatch.setattr(pdev.torch.cuda, "mem_get_info",
                        lambda i: (int(free_gb[i] * 1e9), int(80e9)))
    monkeypatch.setattr(pdev.torch.cuda, "get_device_name", lambda i: "Fake H100")


def test_pick_devices_reads_free_memory(monkeypatch):
    _fake_cards(monkeypatch, [70.0, 12.5])
    assert pdev.pick_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert pdev.pick_devices(1, 40) == [torch.device("cuda", 0)]
    with pytest.raises(RuntimeError, match="need 2 CUDA devices with 40"):
        pdev.pick_devices(2, 40)
    assert pdev.device_summary() == ("cuda:0 Fake H100 70.0/80.0 GB free, "
                                     "cuda:1 Fake H100 12.5/80.0 GB free")


def test_pick_devices_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(pdev.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="have none"):
        pdev.pick_devices(1)
    assert pdev.device_summary() == "cpu"


def test_entry_runs_the_bf16_fast_forward():
    fn, args = entry("cpu")
    params, x = args
    assert x.shape == (1, 128, 128, 128, 2) and x.device.type == "cpu"
    y = fn(*args)
    assert y.shape == (1, 128, 128, 128) and y.dtype == torch.float32
    assert torch.isfinite(y).all() and 0 <= float(y.min()) and float(y.max()) <= 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
