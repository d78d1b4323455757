"""The port's whole curriculum on a mesh, on the CPU, without JAX:
`run_full_curriculum(PipelineConfig(mesh=...))` on 2 ranks over gloo
(`parallel.spawn`, one thread each), one epoch a stage, on the 32^3 tube
cases of `tests/test_torch_parallel_drivers.py` (4 train, 1 val), cube
24, batch 2, float32.

Asserted: the on-disk contract of tests/test_torch_curriculum.py; every
step's batch size (stage 1 four B=2 steps, stages 2/3 four and the
replay's two replicated B=1 steps each) and loss equal on both ranks;
both ranks run the priors between the stages (`save_stage_pred` twice,
`save_weight_break` once) and every validation (stages 1, 2, 3 and the
two DTI re-validations), each on its share of the cases: of the 5 cases
rank 0 predicts 0, 2, 4 and rank 1 1, 3, each time; the one val case is
rank 0's.
"""

import math
import os
from unittest import mock

import pytest
import torch

from se_unet_airseg_tpu_torch.infer import engine as peng
from se_unet_airseg_tpu_torch.models import SEUNetConfig
from se_unet_airseg_tpu_torch.parallel import spawn
from se_unet_airseg_tpu_torch.pipeline import orchestrate, priors
from se_unet_airseg_tpu_torch.pipeline.orchestrate import PipelineConfig, run_full_curriculum
from se_unet_airseg_tpu_torch.train import stages as pstages

from test_torch_parallel_drivers import BATCH, CUBE, N_TRAIN, _write_env


def _curriculum_rank(mesh, env: dict, root: str) -> dict:
    """run_full_curriculum on one rank; its steps and the prior and
    validation calls it made."""
    rec = {"steps": [], "calls": {"save_stage_pred": 0, "save_weight_break": 0, "validate": 0},
           "pred_files": [], "validated": []}
    make = pstages.make_resilient_step
    write_nifti, evaluation_case = priors.write_nifti, peng.evaluation_case

    def pred_file(path, *a, **k):
        rec["pred_files"].append(os.path.basename(path))
        return write_nifti(path, *a, **k)

    def validated(pred, label, name, *a, **k):
        rec["validated"].append(name)
        return evaluation_case(pred, label, name, *a, **k)

    def counting(name, fn):
        def call(*a, **k):
            rec["calls"][name] += 1
            return fn(*a, **k)
        return call

    def recorded(*a, **k):
        step = make(*a, **k)

        def run(state, batch, **draws):
            state, aux = step(state, batch, **draws)
            rec["steps"].append((batch["image"].shape[0], float(aux["loss"])))
            return state, aux
        return run

    with mock.patch.object(pstages, "make_resilient_step", recorded), \
            mock.patch.multiple(orchestrate,
                                save_stage_pred=counting("save_stage_pred",
                                                         orchestrate.save_stage_pred),
                                save_weight_break=counting("save_weight_break",
                                                           orchestrate.save_weight_break)), \
            mock.patch.object(peng, "validate", counting("validate", peng.validate)), \
            mock.patch.object(priors, "write_nifti", pred_file), \
            mock.patch.object(peng, "evaluation_case", validated):
        run_full_curriculum(PipelineConfig(
            data_root=env["data_root"], file_root=env["file_root"],
            saved_model=os.path.join(root, "saved_model"), log_dir=os.path.join(root, "LOG"),
            epochs=(1, 1, 1), batch_size=BATCH, cube=CUBE, model_cfg=SEUNetConfig(),
            mesh=mesh, device="cpu"))
    return rec


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_curriculum_on_a_mesh(tmp_path, one_thread):
    env = _write_env(tmp_path)
    ranks = spawn(_curriculum_rank, 2, env, str(tmp_path), timeout_s=300)
    replay = [1] * int(N_TRAIN * BATCH * 0.3)
    assert [b for b, _ in ranks[0]["steps"]] == [BATCH] * N_TRAIN + (
        [BATCH] * N_TRAIN + replay) * 2
    assert all(math.isfinite(v) for _, v in ranks[0]["steps"])
    assert ranks[1]["steps"] == ranks[0]["steps"]
    for r, rank in enumerate(ranks):
        assert rank["calls"] == {"save_stage_pred": 2, "save_weight_break": 1, "validate": 5}
        assert rank["pred_files"] == [f"CASE{i:03d}.nii.gz" for i in range(r, N_TRAIN + 1, 2)] * 2
    assert ranks[0]["validated"] == [f"CASE{N_TRAIN:03d}"] * 5 and ranks[1]["validated"] == []
    for stage in ("stage_one", "stage_two", "stage_three"):
        assert os.path.exists(tmp_path / "saved_model" / stage / "SE_UNet_0.pt"), stage
        assert os.path.exists(tmp_path / "LOG" / f"log_{stage}.txt")
    names = [f"CASE{i:03d}" for i in range(N_TRAIN + 1)]
    file_root = tmp_path / "data"
    for n in names:
        for d in ("pred_1", "pred_2"):
            assert os.path.exists(file_root / d / f"{n}.nii.gz"), (d, n)
    for n in names[:N_TRAIN]:
        for d in ("BR_weight", "br_skel"):
            assert os.path.exists(file_root / d / f"{n}.npy"), (d, n)
    for stage in ("two", "three"):
        assert os.path.exists(tmp_path / "LOG" / f"log_stage_{stage}.txt.dti")
