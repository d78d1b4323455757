"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file: configurations, traffic mixes and their drivers, each
cell's limits, each metric's reader."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = BENCH["workloads"]


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_text_ok(w) for w in cmd)
    files = [w for w in cmd if "/" in w]
    assert files and all(any(w.startswith(p + "/") for p in BENCH["paths"]) for w in files)
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


@pytest.mark.parametrize("entry", [m["name"] for m in METRICS] + [c["name"] for c in CELLS]
                         + [c["name"] for c in BENCH["configs"]])
def test_names_follow_the_character_rule(entry):
    assert NAME.match(entry), entry


def test_names_are_unique():
    for group in (METRICS, CELLS, BENCH["configs"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if metric in BENCH["end_to_end"] else {"layer", "moves"}
    assert set(metric) <= allowed and set(metric) >= allowed - {"workloads"}
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in CELLS}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert _text_ok(metric["layer"])
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        # the cells that read it report the metric it moves
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_is_found_by_name(metric):
    path = ROOT / "portbench" / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("reader_" + metric["name"], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c["name"])
def test_cell_files_are_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and _text_ok(cell["why"]) and NAME.match(cell["traffic"])
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "portbench" / "drivers" / f"{mix['driver']}.py").is_file()
    limits = json.loads((ROOT / "portbench" / "checks" / f"{cell['name']}.json").read_text())
    assert limits and all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())
    assert (ROOT / conf["file"]).is_file()


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c["name"])
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    def reports(group):
        return [m["name"] for m in group if cell["name"] in m.get("workloads", [cell["name"]])]

    e2e = reports(BENCH["end_to_end"])
    assert "setup_s" in e2e and len(e2e) >= 2
    assert reports(BENCH["per_layer"])


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["source"].startswith("https://") and _text_ok(conf["source"])
    assert any(conf["file"].startswith(p + "/") for p in BENCH["paths"])
    body = json.loads((ROOT / conf["file"]).read_text())
    assert body["reduced"] == conf["reduced"] == []
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert any(c["config"] == conf["name"] for c in CELLS)


def test_a_pair_of_config_and_traffic_appears_once():
    pairs = [(c["config"], c["traffic"]) for c in CELLS]
    assert len(pairs) == len(set(pairs))
