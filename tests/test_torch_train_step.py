"""One optimizer step of the port (se_unet_airseg_tpu_torch.train) against
JAX `make_train_step`, on the CPU, for stages 1, 2 and 3: the full
channel plan, 32^3 crops, batch 2, float32, one weight set, the same
numpy batch and DropLayer draws on both sides. Compared: the loss and
every aux value (per-crop GUL included), the gradients each step applied
(rtol 5e-3, atol 5e-4, as tests/test_fast_path.py, and each leaf within
5e-2 of its own norm, as tests/test_torch_train.py), and the updated
parameters through the inverse weight bridge. Also the LR schedule and setter, and
the out-of-memory fallback of `make_resilient_step`."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from se_unet_airseg_tpu.models import SEUNetConfig as JaxConfig
from se_unet_airseg_tpu.train import step as jstep
from se_unet_airseg_tpu_torch.models import SEUNet, SEUNetConfig, jax_params_from_torch
from se_unet_airseg_tpu_torch.models.se_unet import _tree_map
from se_unet_airseg_tpu_torch.train import (
    create_train_state,
    current_learning_rate,
    make_optimizer,
    make_resilient_step,
    make_train_step,
    multistep_lr,
    set_learning_rate,
)

B, S = 2, 32
LR = 1e-4
RTOL, ATOL = 5e-3, 5e-4  # tests/test_fast_path.py
LEAF_RTOL = 5e-2  # LEAF_RTOL_JAX of tests/test_torch_train.py


@pytest.fixture(scope="module")
def setup():
    model = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(3))
    r = np.random.default_rng(4)
    label = (r.random((B, S, S, S)) > 0.7).astype(np.float32)
    batch = {"image": r.random((B, S, S, S, 2)).astype(np.float32), "label": label,
             "weight": (0.5 + r.random((B, S, S, S))).astype(np.float32),
             "skel": (label * (r.random((B, S, S, S)) > 0.6)).astype(np.float32)}
    key = jax.random.key(5)
    k_en, k_de = jax.random.split(key)  # as JAX apply_fast splits its rng
    draws = [np.array(jax.random.uniform(k, (B, 1, 1, 1, c), jnp.float32)).reshape(B, c)
             for k, c in ((k_en, 24), (k_de, 12))]
    return model.params_tree(), batch, key, draws


def _recording(opt):
    """`opt` that also keeps the gradients of its last update in its
    state: the JAX step then hands back the gradients it applied."""
    def init(params):
        return opt.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = opt.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _adamw_first_step(p, g):
    """AdamW's first step from p with the gradient g (bias-corrected
    moments g and g^2): p (1 - lr wd) - lr g / (|g| + eps)."""
    return p * (1 - LR * 1e-2) - LR * g / (np.abs(g) + 1e-8)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_train_step_matches_jax(stage, setup):
    tree, batch, key, draws = setup
    old = jax_params_from_torch(tree)

    opt, _ = jstep.make_optimizer()
    opt = _recording(opt)
    state = jstep.create_train_state(jax.tree.map(jnp.asarray, old), opt)
    step = jstep.make_train_step(opt, JaxConfig(), stage=stage)
    ref_state, ref_aux = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    popt, _ = make_optimizer()
    pstate = create_train_state(tree, popt)
    pstep = make_train_step(SEUNetConfig(), stage=stage)
    pstate, aux = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                        drop_draws=[torch.from_numpy(d) for d in draws])
    assert pstate.step == 1 and int(ref_state.step) == 1

    assert set(aux) == set(ref_aux)
    for k, v in ref_aux.items():
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    if stage > 1:
        assert aux["per_crop_gul"].shape == (B,)

    # the gradients the two steps applied (a leaf the forward does not
    # reach, dc62, has none in the port and zeros in JAX)
    pgrads = jax_params_from_torch(_tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, pstate.params))
    names = [jax.tree_util.keystr(path)
             for path, _ in jax.tree_util.tree_flatten_with_path(old)[0]]
    leaves = zip(names, jax.tree.leaves(old), jax.tree.leaves(pgrads),
                 jax.tree.leaves(ref_state.opt_state[1]),
                 jax.tree.leaves(jax_params_from_torch(pstate.params)),
                 jax.tree.leaves(ref_state.params))
    floor = 1e-6 * max(np.linalg.norm(g) for g in jax.tree.leaves(ref_state.opt_state[1]))
    for name, o, g_port, g_ref, p_port, p_ref in leaves:
        g_ref, p_ref = np.asarray(g_ref), np.asarray(p_ref)
        np.testing.assert_allclose(g_port, g_ref, rtol=RTOL, atol=ATOL, err_msg=name)
        assert np.linalg.norm(g_port - g_ref) <= LEAF_RTOL * np.linalg.norm(g_ref) + floor, name
        # each side took AdamW's first step with its own gradient (the
        # same optimizer), so the updated parameters differ only where
        # the gradients do: by at most 2 lr, where a gradient that is
        # zero up to rounding (a conv bias in front of an InstanceNorm)
        # took either sign
        for p_new, g in ((p_port, g_port), (p_ref, g_ref)):  # a few float32 ulps
            np.testing.assert_allclose(p_new, _adamw_first_step(o, g), rtol=1e-6,
                                       atol=1e-8, err_msg=name)
        assert np.abs(p_port - p_ref).max() <= 2.001 * LR, name


def test_learning_rate_schedule_and_setter():
    opt, lr_fn = make_optimizer()
    jopt, jlr_fn = jstep.make_optimizer()
    for n in (0, 59, 60, 89, 90, 500):
        assert lr_fn(n) == jlr_fn(n) == multistep_lr(1e-4, (60, 90), 0.1, n)
    params = {"a": {"w": torch.ones(3)}}
    state = create_train_state(params, opt)
    jstate = jstep.create_train_state({"a": {"w": jnp.ones(3)}}, jopt)
    assert current_learning_rate(state) == pytest.approx(jstep.current_learning_rate(jstate))
    state = set_learning_rate(state, lr_fn(75))
    jstate = jstep.set_learning_rate(jstate, jlr_fn(75))
    assert current_learning_rate(state) == pytest.approx(jstep.current_learning_rate(jstate))
    assert current_learning_rate(state) == pytest.approx(1e-5)
    group = state.optimizer.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 1e-2
    # a mesh is a parallel.DataMesh (tests/test_torch_parallel*.py), and
    # the `space` axis needs one (tests/test_torch_parallel_space.py)
    with pytest.raises(TypeError, match="DataMesh"):
        make_train_step(SEUNetConfig(), mesh=object())
    with pytest.raises(ValueError, match="shard_space"):
        make_train_step(SEUNetConfig(), shard_space=True)


def test_resilient_step_rebuilds_once_on_oom():
    """The first out-of-memory error rebuilds the step with remat=True
    and retries the batch; a second one propagates."""
    built, calls = [], []

    def make(cfg, stage, mesh, shard_space, fast):
        built.append(cfg.remat)

        def step(state, batch, rng=None, **kw):
            calls.append(cfg.remat)
            if len(calls) in (1, 3):
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return state, {"loss": torch.tensor(0.0)}
        return step

    opt, _ = make_optimizer()
    state = create_train_state({"w": torch.ones(2)}, opt)
    step = make_resilient_step(SEUNetConfig(), stage=1, _make_step=make)
    assert not step.fallback_active()
    state, aux = step(state, {})
    assert built == [False, True] and calls == [False, True]
    assert step.fallback_active()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        step(state, {})
    assert built == [False, True]
