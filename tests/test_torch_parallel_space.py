"""The port's `space` axis (each crop's depth split over ranks) against the
JAX package's `make_train_step(..., shard_space=True)` on its virtual
8-device CPU mesh, and against the port in one process.

Four ranks over gloo on the CPU, a (data 2, space 2) mesh
(`parallel.spawn(n_space=2)`, one intra-op thread each; the one-process
runs here take one thread too). JAX runs
`make_train_step(mesh=make_mesh(n_data=4, n_space=2), shard_space=True)`
(tests/test_parallel.py:29-58). Same weights through the bridge, the same
numpy inputs and JAX's DropLayer draws on both sides. The spawned ranks
run while JAX compiles its step, in a second thread of this process.

  * Stage-3 step, B=8 at 16^3, float32: against JAX the loss within rtol
    1e-5 and every parameter within 2.5e-4 (Adam's first step is about
    +-lr sign(g), tests/test_parallel.py:51-58), the bulk tighter: at most
    BULK_SHARE of the elements beyond BULK_ATOL. A depth split flips the
    sign of many gradient elements that are rounding alone: JAX's own
    (4, 2) step differs from its one-device step beyond 1e-6 in 19.5% of
    the elements (the data axis alone: 0.69%), the port's (2, 2) step from
    JAX's (4, 2) in 19.7% (measured). Adam's first step hides the size of
    a gradient, so the port's gradients are also held, leaf by leaf
    within F32_LEAF_RTOL of its norm, against JAX's one-device step's
    (its first moment over 1 - b1; measured 3.5e-5). Not against JAX's
    (4, 2) step: its gradients depart from its one-device step's by up to
    25x a leaf's norm in the encoder (ec1-ec10, growing along the
    backward from ec12), with the same loss, while its (8, 1) data mesh
    agrees within 3e-5 (measured). Against one process: the loss
    within rtol 1e-6, every aux within rtol 1e-6 (`per_crop_gul` of shape
    (B,): its sums add over the slabs before the ratio), the ranks'
    parameters bitwise equal, each gradient leaf within F32_LEAF_RTOL of
    its norm. The depth split adds each crop's statistics in another
    order, which moves the forward by about an ulp; a one-ulp change of
    the input moves a leaf of this step by 6.5e-3 in one process (max
    pool ties and the sums in front of each InstanceNorm), so float32
    cannot hold a leaf to 1e-4. The same step with float32 parameters and
    `compute_dtype=float64` holds each leaf within LEAF_RTOL = 1e-4 of one
    process's. Planted faults, measured: an identity backward of
    `space_sum` moves a leaf by 180x its norm, a halo backward that keeps
    the neighbours' cotangent moves one by 0.87, in both types.
  * `remat=True`: the ranks' step against one process's at the same
    bounds (remat replays the halo exchanges and sums).
  * The eval forwards `apply_fast` and `apply` on each rank's rows and
    slab, gathered, against one process within FWD_ATOL; the runner on the
    2-D mesh (cube 32, step 16, batch 4: 2 tiles a data row, 16 planes a
    slab) against one process's within FWD_ATOL.
  * `entry.dryrun_multichip(4, "cpu")`: a (2, 2) mesh with the space axis.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from se_unet_airseg_tpu_torch.entry import dryrun_multichip
from se_unet_airseg_tpu_torch.infer import SlidingWindowRunner
from se_unet_airseg_tpu_torch.models import SEUNet, SEUNetConfig
from se_unet_airseg_tpu_torch.models.se_unet import _leaves, _tree_map, apply, apply_fast
from se_unet_airseg_tpu_torch.parallel import all_gather_rows, all_gather_slabs, spawn
from se_unet_airseg_tpu_torch.train import create_train_state, make_optimizer, make_train_step

N, N_SPACE = 4, 2
B, S = 8, 16
CUBE, STEP, VOL = 32, 16, (48, 32, 32)
BULK_ATOL = 1e-6
BULK_SHARE = 0.25       # measured 0.197 (see the docstring)
LEAF_RTOL = 1e-4        # float64 compute; measured 1.2e-5
F32_LEAF_RTOL = 5e-2    # float32; measured 1.7e-3 on JAX's draws, 1.1e-2 on others
FWD_ATOL = 1e-5         # measured 2.3e-6 (heads of 16^3 crops), 5.7e-7 (runner)
SIDES = (24, 12)
CONFIGS = {"f32": SEUNetConfig(), "f64": SEUNetConfig(compute_dtype=torch.float64),
           "remat": SEUNetConfig(remat=True)}


def _inputs():
    r = np.random.default_rng(0)
    label = (r.random((B, S, S, S)) > 0.7).astype(np.float32)
    batch = {"image": r.random((B, S, S, S, 2), np.float32), "label": label,
             "weight": r.random((B, S, S, S)).astype(np.float32),
             "skel": (r.random((B, S, S, S)) > 0.9).astype(np.float32)}
    vol = (np.random.default_rng(1).random(VOL) * 1000 - 900).astype(np.float32)
    tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(2)).params_tree()
    return batch, vol, _tree_map(lambda t: t.detach().clone(), tree)


def _run(mesh, tree, batch, draws, vol):
    """The stage-3 step in each configuration of CONFIGS, the two eval
    forwards and the runner, on a rank of `mesh` or (mesh None) in this
    process; results on the CPU."""
    out = {}
    for name, cfg in CONFIGS.items():
        state = create_train_state(_tree_map(lambda t: t.clone(), tree), make_optimizer()[0])
        step = make_train_step(cfg, stage=3, mesh=mesh, shard_space=mesh is not None)
        b = batch if mesh is not None else {k: torch.from_numpy(v) for k, v in batch.items()}
        state, aux = step(state, b, drop_draws=draws)
        out[name] = {"aux": aux,
                     "params": _tree_map(lambda t: t.detach().clone(), state.params),
                     "grads": [None if t.grad is None else t.grad.clone()
                               for t in _leaves(state.params)]}
    x = torch.from_numpy(batch["image"])
    with torch.no_grad():
        for name, fwd in (("apply_fast", apply_fast), ("apply", apply)):
            if mesh is None:
                out[name] = fwd(tree, x)
                continue
            heads = fwd(tree, x[mesh.rows(B)][:, mesh.slab(S)], space=mesh)
            out[name] = [all_gather_rows(all_gather_slabs(h, mesh), mesh) for h in heads]
    out["runner"] = SlidingWindowRunner(tree, SEUNetConfig(), cube=CUBE, step=STEP, batch=N,
                                        mesh=mesh, device="cpu").predict_hu(vol)
    return out


def _jax_step(tree, batch, key):
    import jax
    import jax.numpy as jnp
    import optax

    from se_unet_airseg_tpu.models import SEUNetConfig as JaxConfig
    from se_unet_airseg_tpu.parallel import make_mesh
    from se_unet_airseg_tpu.train import step as jstep
    from se_unet_airseg_tpu_torch.models import jax_params_from_torch

    def step(mesh):
        opt, _ = jstep.make_optimizer()
        state = jstep.create_train_state(
            jax.tree.map(jnp.asarray, jax_params_from_torch(tree)), opt)
        return jstep.make_train_step(opt, JaxConfig(), stage=3, mesh=mesh,
                                     shard_space=mesh is not None)(state, batch, key)

    with ThreadPoolExecutor(1) as pool:
        one = pool.submit(step, None)
        state, aux = step(make_mesh(n_data=4, n_space=2))
        one, _ = one.result()
    adam = [s for s in jax.tree.leaves(one.opt_state,
                                       is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
    return {"aux": {k: np.asarray(v) for k, v in aux.items()},
            "params": jax.tree.map(np.asarray, state.params),
            "grads_one_device": jax.tree.map(lambda m: np.asarray(m) / 0.1, adam[0].mu)}


@pytest.fixture(scope="module")
def runs():
    """The port on 4 ranks, in one process, and JAX on a (4, 2) mesh."""
    import jax
    import jax.numpy as jnp

    batch, vol, tree = _inputs()
    key = jax.random.key(42)
    # JAX's DropLayer uniforms for key(42): apply_fast splits it into the heads' keys
    draws = [torch.from_numpy(np.array(jax.random.uniform(k, (B, 1, 1, 1, c), jnp.float32))
                              .reshape(B, c)) for k, c in zip(jax.random.split(key), SIDES)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(spawn, _run, N, tree, batch, draws, vol, n_space=N_SPACE,
                                timeout_s=400)
            ref = _jax_step(tree, batch, key)
            one = _run(None, tree, batch, draws, vol)
            ranks = ranks.result()
    finally:
        torch.set_num_threads(n)
    return ranks, one, ref


def _leaf_ratios(got, ref):
    big = max(float(g.norm()) for g in ref if g is not None)
    out = []
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None and float(r.norm()) > 1e-5 * big:
            out.append(float((g - r).norm() / r.norm()))
    return out


def test_space_sharded_step_matches_jax(runs):
    import jax

    from se_unet_airseg_tpu_torch.models import jax_params_from_torch

    ranks, _, ref = runs
    got = ranks[0]["f32"]
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
    assert beyond <= BULK_SHARE * total, f"{beyond} of {total} elements beyond {BULK_ATOL}"
    # the gradients themselves, against JAX's one-device step (JAX's (4, 2)
    # step departs from it, see the docstring)
    grads = iter(got["grads"])
    gtree = _tree_map(lambda t: torch.zeros_like(t) if (g := next(grads)) is None else g,
                      got["params"])
    mine = [torch.from_numpy(a) for a in jax.tree.leaves(jax_params_from_torch(gtree))]
    theirs = [torch.from_numpy(g) for g in jax.tree.leaves(ref["grads_one_device"])]
    assert max(_leaf_ratios(mine, theirs)) <= F32_LEAF_RTOL


@pytest.mark.parametrize("name,leaf_rtol", [("f32", F32_LEAF_RTOL), ("f64", LEAF_RTOL),
                                            ("remat", F32_LEAF_RTOL)])
def test_space_sharded_step_matches_one_process(runs, name, leaf_rtol):
    ranks, one, _ = runs
    got, want = ranks[0][name], one[name]
    for k, v in want["aux"].items():
        np.testing.assert_allclose(got["aux"][k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert got["aux"]["per_crop_gul"].shape == (B,)
    assert max(_leaf_ratios(got["grads"], want["grads"])) <= leaf_rtol
    # every rank applied the same update: bitwise equal parameters and aux
    for r in ranks[1:]:
        for a, b in zip(_leaves(r[name]["params"]), _leaves(got["params"])):
            assert torch.equal(a, b)
        for k in got["aux"]:
            assert torch.equal(r[name]["aux"][k], got["aux"][k])


def test_remat_replays_the_exchanges_bitwise(runs):
    """remat=True recomputes each block with its halo exchanges and sums in
    the backward: on every rank the loss and gradients equal remat off's."""
    ranks, _, _ = runs
    for r in ranks:
        assert torch.equal(r["remat"]["aux"]["loss"], r["f32"]["aux"]["loss"])
        for a, b in zip(r["remat"]["grads"], r["f32"]["grads"]):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("fwd", ["apply_fast", "apply", "runner"])
def test_space_sharded_forwards_match_one_process(runs, fwd):
    ranks, one, _ = runs
    got = ranks[0][fwd]
    if fwd == "runner":
        assert got.shape == VOL
        np.testing.assert_allclose(got, one[fwd], rtol=0, atol=FWD_ATOL)
    else:
        for g, w in zip(got, one[fwd]):
            assert g.shape == w.shape
            torch.testing.assert_close(g, w, rtol=0, atol=FWD_ATOL)
    for r in ranks[1:]:
        if fwd == "runner":
            np.testing.assert_array_equal(r[fwd], got)
        else:
            for a, b in zip(r[fwd], got):
                assert torch.equal(a, b)


def test_dryrun_multichip_with_the_space_axis():
    """`entry.dryrun_multichip(4)` (JAX `__graft_entry__.dryrun_multichip`):
    a (2, 2) mesh, the stage-3 step and the runner split over space, then
    the eval forward of 2 crops split over data and space (32^3 on the
    CPU, 128^3 on the card), against one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = dryrun_multichip(4, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert out["mesh"] == [2, 2] and out["ranks_equal"]
    np.testing.assert_allclose(out["loss"], out["loss_one_process"], rtol=1e-6)
    assert out["param_max_abs_diff"] <= 2.5e-4  # Adam's first step, as above
    assert out["grad_leaf_norm_ratio_max"] <= F32_LEAF_RTOL
    assert out["score_max_abs_diff"] <= FWD_ATOL
    fwd = out["forward"]
    assert (fwd["crop"], fwd["batch"], fwd["dtype"]) == (32, 2, "float32")
    assert fwd["finite"] and fwd["ranks_equal"] and 0 < fwd["mean"] < 1
    assert fwd["bound"] == 1e-4 and fwd["max_abs_diff"] <= fwd["bound"]
    assert len(fwd["seconds_ranks"]) == 4 and fwd["seconds_one_process"] > 0
    assert fwd["peak_mem_gb_ranks"] == [None] * 4  # not measured on the CPU
