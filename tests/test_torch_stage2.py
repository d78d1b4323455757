"""The port's stage-2 driver (`train/stages.py::train_stage2`) against the
JAX package's, on the CPU: 1 epoch from one seeded weight set, with the
online hard-mining cache (1 crop: the drivers' 30% of the epoch's 4) and
its batch-1 replay, on the drivers, draws, recorders and tolerances of
`tests/test_torch_stages.py`, whose tests run here too. Also: the online
cache's step indices (equal), losses (within LOSS_RTOL) and crops
(equal)."""

import numpy as np
import pytest

from test_torch_stages import (  # noqa: F401  (fixtures and shared tests)
    CACHE_LIMIT,
    LOSS_RTOL,
    env,
    jax_run,
    port_run,
    test_checkpoints_written,
    test_drivers_need_a_device_without_cuda,
    test_final_params_match_jax,
    test_mesh_and_replay_bucket_raise,
    test_steps_match_jax,
    test_validation_matches_jax,
)
from test_torch_sliding_window import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def stage():
    return 2


def test_online_cache_matches_jax(env, jax_run, port_run):  # noqa: F811
    got, want = port_run["cache"], jax_run["cache"]
    assert got.keys() == want.keys() == {"image", "label", "weight"}
    assert len(got["image"]) == len(want["image"]) == CACHE_LIMIT == 1

    def split(names):
        return [(float(f.split("_")[0]), f.split("_")[1]) for f in names]

    for d in got:
        (gl, gi), (wl, wi) = zip(*split(got[d])), zip(*split(want[d]))
        assert gi == wi  # the same steps' crops
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
        for fg, fw in zip(got[d], want[d]):
            np.testing.assert_array_equal(
                np.load(env["root"] / "port" / "online" / d / fg),
                np.load(env["root"] / "jax" / "online" / d / fw))
