"""The controls on the card, at the cells' own sizes: the plain reference in
float8 (the step below the configurations' bfloat16) in the program's place
fails each cell's limits where the program passes them, and so does a step
that leaves half of each batch out. Needs a CUDA card; run from the root:

    python -m pytest portbench/tests/test_portbench_control.py -m cuda -q
"""

from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate, harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run on the GPU only")


def _ctx(workload: str) -> harness.Context:
    bench = harness.load_bench()
    work, conf = harness.cell(bench, workload)
    return harness.Context(
        workload=workload, seed=0, seconds=0.0, trace=False,
        config=json.loads((ROOT / conf["file"]).read_text()),
        mix=json.loads((ROOT / "portbench" / "traffic" / f"{work['traffic']}.json").read_text()),
        limits=json.loads((ROOT / "portbench" / "checks" / f"{workload}.json").read_text()),
        t0=time.perf_counter(), scratch=tempfile.gettempdir())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["infer-bf16-lungbox", "infer-convepi-lungbox"])
def test_the_float8_control_fails_an_inference_cell(card, workload):
    ctx = _ctx(workload)
    row = calibrate.infer(ctx, 2**31 + 41, [1])["volumes"][0]
    limit = ctx.limits["trit_flips"]
    assert row["program"] <= limit < row["control"]


@pytest.mark.cuda
def test_the_float8_control_and_half_batches_fail_the_training_cells(card):
    ctx = _ctx("train-bf16-s1-resident")
    row = calibrate.train(ctx, 2**31 + 43)
    lim = ctx.limits
    assert all(row["program"][n][0] <= lim[n] for n in lim)
    for bad in ("control", "half_batch"):
        assert any(row[bad][n][0] > lim[n] for n in lim), bad
