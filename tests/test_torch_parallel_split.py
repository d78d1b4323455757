"""Work between the train steps split by case over the ranks
(`DataMesh.cases`), port only, on the CPU over gloo (`parallel.spawn`, one
thread a rank): `save_stage_pred`, `save_weight_break` and `validate` on 2
ranks write the files and return the values of one process, and no rank
waits in a collective while another works through a whole split.

8 tube cases of 32^3 (4 train, 4 val; the priors take all 8, validation
the 4 val), cube 24, float32, random weights. On each rank the process
group's timeout is cut to GROUP_TIMEOUT_S and each case of the three is
slowed by CASE_SLEEP_S, so one rank working through a whole split (8 *
CASE_SLEEP_S at the least) would hold the other in a barrier or in the
metrics' all_reduce past the timeout, and gloo would raise there. Split,
each rank takes 4 of the 8 cases and 2 of the 4 to validate, and its waits
are the ranks' differences.

Against one process on the same weights: the pred files and break priors
bitwise equal, validate's four means and the LOG text equal (each case
sees the draws of one process: a rank advances the generator past the
other rank's cases).
"""

import datetime
import os
import time
from unittest import mock

import numpy as np
import pytest
import torch
from torch.distributed.distributed_c10d import _set_pg_timeout

from se_unet_airseg_tpu_torch.infer import engine as peng
from se_unet_airseg_tpu_torch.io import read_nifti
from se_unet_airseg_tpu_torch.models import SEUNetConfig
from se_unet_airseg_tpu_torch.parallel import spawn
from se_unet_airseg_tpu_torch.pipeline import priors

from test_torch_parallel_drivers import CUBE, _tree, _write_env

N_TRAIN, N_VAL = 4, 4
CASE_SLEEP_S = 2.0
GROUP_TIMEOUT_S = 8.0


def _section(env: dict, out: str, mesh=None) -> dict:
    """pred_2 over train+val, the break priors from it and a stage-2
    validation of the val cases, as `run_full_curriculum` runs them."""
    fp, cfg = env["file_path"], SEUNetConfig()
    pred = os.path.join(out, "pred_2")
    priors.save_stage_pred(_tree(), cfg, fp, env["data_root"], pred, cube=CUBE,
                           step=CUBE // 2, device="cpu", mesh=mesh)
    priors.save_weight_break(env["data_root"], pred, os.path.join(out, "BR_weight"),
                             os.path.join(out, "br_skel"), fp, mesh=mesh)
    if mesh is not None:
        mesh.barrier()
    names = [f"CASE{i:03d}" for i in range(N_TRAIN, N_TRAIN + N_VAL)]
    means = peng.validate(_tree(), cfg, names, env["data_root"], env["file_root"], 3,
                          os.path.join(out, "LOG.txt"), stage=2, cube=CUBE, step=CUBE // 2,
                          device="cpu", mesh=mesh)
    return {"means": means}


def _split_rank(mesh, env: dict, out: str) -> dict:
    """`_section` on one rank with the group's timeout cut and every case
    slowed; the cases this rank took."""
    _set_pg_timeout(datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    took = {"pred": [], "break": [], "validate": []}

    def slow(kind, fn, name_of):
        def call(*a, **k):
            took[kind].append(name_of(*a, **k))
            time.sleep(CASE_SLEEP_S)
            return fn(*a, **k)
        return call

    with mock.patch.object(priors, "write_nifti", slow(
            "pred", priors.write_nifti, lambda path, *a, **k: os.path.basename(path))), \
            mock.patch.object(priors, "skeletonize_3d", slow(
                "break", priors.skeletonize_3d, lambda *a, **k: None)), \
            mock.patch.object(peng, "evaluation_case", slow(
                "validate", peng.evaluation_case, lambda pred, label, name, *a, **k: name)):
        t0 = time.perf_counter()
        res = _section(env, out, mesh)
    return {**res, "took": took, "seconds": time.perf_counter() - t0}


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    root = tmp_path_factory.mktemp("parallel_split")
    env = _write_env(root, N_TRAIN, N_VAL)
    ranks = spawn(_split_rank, 2, env, str(root / "mesh"), timeout_s=240)
    one = _section(env, str(root / "one"))
    return ranks, one, root


def test_the_split_outlasts_the_group_timeout_on_no_rank(runs):
    """Each rank took every other case of each split; one rank's share of
    the sleeps alone is past the group's timeout, and the run finished."""
    ranks, _, _ = runs
    for r, rank in enumerate(ranks):
        assert rank["took"]["pred"] == [f"CASE{i:03d}.nii.gz" for i in range(r, 8, 2)]
        assert len(rank["took"]["break"]) == 4
        assert rank["took"]["validate"] == [f"CASE{i:03d}" for i in range(N_TRAIN + r, 8, 2)]
        assert rank["seconds"] >= 10 * CASE_SLEEP_S > GROUP_TIMEOUT_S
    assert 8 * CASE_SLEEP_S > GROUP_TIMEOUT_S  # one rank alone would time the other out


def test_the_split_equals_one_process(runs):
    ranks, one, root = runs
    for r in ranks:
        assert r["means"] == one["means"]
    for log in ("LOG.txt", "LOG.txt.jsonl"):
        with open(root / "mesh" / log) as f, open(root / "one" / log) as g:
            assert f.read() == g.read()
    for d in ("pred_2", "BR_weight", "br_skel"):
        names = sorted(os.listdir(root / "one" / d))
        assert sorted(os.listdir(root / "mesh" / d)) == names and len(names) == 8
        for n in names:
            a, b = root / "mesh" / d / n, root / "one" / d / n
            if n.endswith(".nii.gz"):
                assert np.array_equal(read_nifti(str(a)).array, read_nifti(str(b)).array), n
            else:
                assert np.array_equal(np.load(a), np.load(b)), n
