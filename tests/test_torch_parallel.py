"""The port's data parallelism (`parallel/mesh.py`, the sharded
`train/step.py` and `infer/sliding_window.py`) against the JAX package's
on its virtual 8-device CPU mesh, and against the port in one process.

Four ranks over gloo on the CPU (`parallel.spawn`, one intra-op thread
each; the one-process runs here take one thread too, since a thread count
changes the float32 rounding of the convs). JAX runs
`make_train_step(mesh=make_mesh(n_data=4, n_space=1))` and the runner on
the same mesh. Same weights through the bridge, the same numpy inputs and
JAX's DropLayer draws on both sides (the global (B, C) draws; each rank
uses its rows).

  * Stage-3 step, B=8 at 16^3 (tests/test_parallel.py's shapes): against
    JAX the loss within rtol 1e-5 and every parameter within 2.5e-4
    (Adam's first step is about +-lr sign(g): a gradient that is zero up to
    rounding may step either way, tests/test_parallel.py:51-58); the bulk
    tighter: at most 2% of the elements beyond BULK_ATOL. Against the
    port in one process: the loss within rtol 1e-6, each gradient leaf
    within LEAF_RTOL of its norm, the parameters of the ranks bitwise
    equal.
  * Runner, cube 32, step 16, batch 4 (one tile a rank) over a 48x32x32
    volume, eval and train mode: against JAX's sharded runner within rtol
    1e-4, atol 1e-5; against the port's one-process runner within
    ONE_PROCESS_ATOL (the one-process runner batches 4 tiles a forward, a
    rank 1, and takes the s2d-folded route).

Also `entry.dryrun_multichip(2, "cpu")`. The rank program imports no
JAX; JAX runs in this module's fixtures. The mesh's `space` axis (a crop's
depth over ranks) is held in tests/test_torch_parallel_space.py and
tests/test_torch_space_ops.py.
"""

import numpy as np
import pytest
import torch

from se_unet_airseg_tpu_torch.data import pad_positions_to_batch, tile_positions
from se_unet_airseg_tpu_torch.entry import dryrun_multichip
from se_unet_airseg_tpu_torch.infer import SlidingWindowRunner
from se_unet_airseg_tpu_torch.models import SEUNet, SEUNetConfig
from se_unet_airseg_tpu_torch.models.se_unet import _leaves, _tree_map
from se_unet_airseg_tpu_torch.parallel import DataMesh, spawn
from se_unet_airseg_tpu_torch.train import create_train_state, make_optimizer, make_train_step

N = 4
B, S = 8, 16
CUBE, STEP, VOL = 32, 16, (48, 32, 32)
BULK_ATOL = 1e-6     # measured: 0.69% of the elements differ by more
LEAF_RTOL = 1e-4     # measured: 1.24e-5 (each leaf above 1e-5 of the largest norm)
ONE_PROCESS_ATOL = 1e-6  # measured: 2.4e-7
SIDES = (24, 12)


def _inputs():
    r = np.random.default_rng(0)
    label = (r.random((B, S, S, S)) > 0.7).astype(np.float32)
    batch = {"image": r.random((B, S, S, S, 2), np.float32), "label": label,
             "weight": r.random((B, S, S, S)).astype(np.float32),
             "skel": (r.random((B, S, S, S)) > 0.9).astype(np.float32)}
    vol = (np.random.default_rng(1).random(VOL) * 1000 - 900).astype(np.float32)
    tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(2)).params_tree()
    return batch, vol, _tree_map(lambda t: t.detach().clone(), tree)


def _run(mesh, tree, batch, draws, vol, vol_draws):
    """One stage-3 step and the runner in eval and train mode, on a rank
    of `mesh` or (mesh None) in this process; results on the CPU."""
    state = create_train_state(tree, make_optimizer()[0])
    step = make_train_step(SEUNetConfig(), stage=3, mesh=mesh)
    if mesh is None:
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, aux = step(state, batch, drop_draws=draws)
    out = {"aux": aux, "params": _tree_map(lambda t: t.detach().clone(), state.params),
           "grads": [None if t.grad is None else t.grad.clone() for t in _leaves(state.params)]}
    kw = dict(cube=CUBE, step=STEP, batch=N, mesh=mesh, device="cpu")
    out["eval"] = SlidingWindowRunner(tree, SEUNetConfig(), **kw).predict_hu(vol)
    out["train"] = SlidingWindowRunner(tree, SEUNetConfig(), train_mode=True, **kw).predict_hu(
        vol, drop_draws=vol_draws)
    return out


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_draws():
    """JAX's DropLayer uniforms: the step's for key(42) (apply_fast splits
    its rng into the two heads' keys), the runner's per tile batch for
    key(7) (fold_in(key, i), split)."""
    import jax
    import jax.numpy as jnp

    from test_torch_sliding_window import jax_drop_draws

    key = jax.random.key(42)
    step = [np.array(jax.random.uniform(k, (B, 1, 1, 1, c), jnp.float32)).reshape(B, c)
            for k, c in zip(jax.random.split(key), SIDES)]
    vol_key = jax.random.key(7)
    n_batches = len(pad_positions_to_batch(tile_positions(VOL, CUBE, STEP), N)) // N
    return key, step, vol_key, jax_drop_draws(vol_key, n_batches, N)


@pytest.fixture(scope="module")
def runs(one_thread, jax_draws):
    """The port on 4 ranks and in one process, and JAX on a (4, 1) mesh."""
    import jax
    import jax.numpy as jnp

    from se_unet_airseg_tpu.infer import SlidingWindowRunner as JaxRunner
    from se_unet_airseg_tpu.models import SEUNetConfig as JaxConfig
    from se_unet_airseg_tpu.parallel import make_mesh
    from se_unet_airseg_tpu.train import step as jstep
    from se_unet_airseg_tpu_torch.models import jax_params_from_torch

    batch, vol, tree = _inputs()
    key, draws, vol_key, vol_draws = jax_draws
    draws = [torch.from_numpy(d) for d in draws]
    ranks = spawn(_run, N, tree, batch, draws, vol, vol_draws, timeout_s=300)
    one = _run(None, _tree_map(lambda t: t.clone(), tree), batch, draws, vol, vol_draws)

    jp = jax_params_from_torch(tree)
    mesh = make_mesh(n_data=N, n_space=1)
    opt, _ = jstep.make_optimizer()
    state = jstep.create_train_state(jax.tree.map(jnp.asarray, jp), opt)
    state, aux = jstep.make_train_step(opt, JaxConfig(), stage=3, mesh=mesh)(state, batch, key)
    kw = dict(cube=CUBE, step=STEP, batch=N, mesh=mesh)
    ref = {"aux": {k: np.asarray(v) for k, v in aux.items()},
           "params": jax.tree.map(np.asarray, state.params),
           "eval": np.asarray(JaxRunner(jp, JaxConfig(), **kw).predict_hu(vol)),
           "train": np.asarray(JaxRunner(jp, JaxConfig(), train_mode=True, **kw).predict_hu(
               vol, rng=vol_key))}
    return ranks, one, ref, tree


def test_sharded_step_matches_jax(runs):
    import jax

    from se_unet_airseg_tpu_torch.models import jax_params_from_torch

    ranks, _, ref, _ = runs
    got = ranks[0]
    assert set(got["aux"]) == set(ref["aux"])
    np.testing.assert_allclose(float(got["aux"]["loss"]), float(ref["aux"]["loss"]), rtol=1e-5)
    for k, v in ref["aux"].items():
        np.testing.assert_allclose(got["aux"][k].numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)
    mine = jax.tree.leaves(jax_params_from_torch(got["params"]))
    theirs = jax.tree.leaves(ref["params"])
    beyond = sum(int((np.abs(a - b) > BULK_ATOL).sum()) for a, b in zip(mine, theirs))
    total = sum(a.size for a in mine)
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a, b, rtol=0, atol=2.5e-4)
    assert beyond <= 0.02 * total, f"{beyond} of {total} elements beyond {BULK_ATOL}"


def test_sharded_step_matches_one_process(runs):
    ranks, one, _, _ = runs
    for k, v in one["aux"].items():
        np.testing.assert_allclose(ranks[0]["aux"][k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    big = max(float(g.norm()) for g in one["grads"] if g is not None)
    for g, ref in zip(ranks[0]["grads"], one["grads"]):
        assert (g is None) == (ref is None)
        if ref is not None and float(ref.norm()) > 1e-5 * big:
            assert float((g - ref).norm()) <= LEAF_RTOL * float(ref.norm())
    # every rank applied the same update: bitwise equal parameters and
    # global aux on every rank
    for r in ranks[1:]:
        for a, b in zip(_leaves(r["params"]), _leaves(ranks[0]["params"])):
            assert torch.equal(a, b)
        for k in ranks[0]["aux"]:
            assert torch.equal(r["aux"][k], ranks[0]["aux"][k])
    assert ranks[0]["aux"]["per_crop_gul"].shape == (B,)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_sharded_runner_matches_jax_and_one_process(runs, mode):
    ranks, one, ref, _ = runs
    got = ranks[0][mode]
    assert got.shape == VOL
    np.testing.assert_allclose(got, ref[mode], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, one[mode], rtol=0, atol=ONE_PROCESS_ATOL)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[mode], got)
    if mode == "train":  # the draws change the scores
        assert np.abs(got - ranks[0]["eval"]).max() > 1e-3


def test_runner_batch_must_divide_over_the_ranks(runs):
    tree = runs[3]
    mesh = DataMesh(rank=0, size=N, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="multiple"):
        SlidingWindowRunner(tree, SEUNetConfig(), cube=CUBE, step=STEP, batch=N + 2, mesh=mesh,
                            device="cpu")


def test_dryrun_multichip_on_the_cpu(one_thread):
    """`entry.dryrun_multichip` (JAX `__graft_entry__.dryrun_multichip`,
    on the `data` axis only): 2 ranks against one process."""
    out = dryrun_multichip(2, device="cpu")
    assert out["ranks_equal"]
    np.testing.assert_allclose(out["loss"], out["loss_one_process"], rtol=1e-6)
    assert out["param_max_abs_diff"] <= 2.5e-4  # Adam's first step, as above
    assert out["score_max_abs_diff"] <= ONE_PROCESS_ATOL
