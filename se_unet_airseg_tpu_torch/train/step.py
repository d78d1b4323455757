"""Training step of the 3-stage curriculum, on one GPU.

The reference's step (reference train.py:582-603, 417-453, 218-267):
sigmoid heads, stage loss, backward, AdamW. Here: the train-mode fast
forward (`apply_fast(train=True)`, whose fused blocks and s2d max pool
carry the JAX package's hand-written backwards), the stage loss over
the whole batch (the global-sum losses flatten every crop), backward,
and a `torch.optim.AdamW` step.

AdamW hyperparameters are the torch defaults the reference relies on
(lr 1e-4, betas (0.9, 0.999), eps 1e-8, weight decay 0.01; reference
train.py:567-572). The learning rate is set from outside, per epoch, by
the stage drivers (`set_learning_rate(state, multistep_lr(...))`).

The step also returns per-crop GUL losses (stages 2/3), the signal the
online hard-mining cache keys its filenames on (reference
train.py:442-453).

Counterpart of the JAX package's `train/step.py`, with these
differences:
  * The parameters are a tree of leaf tensors that the step updates in
    place; the torch optimizer, a stateful object, lives in the
    `TrainState`, so the step builders take no optimizer argument.
  * Sharded training (`mesh`, `shard_space`) is not ported yet and
    raises NotImplementedError.
  * `make_resilient_step` falls back on `torch.cuda.OutOfMemoryError`.
    The JAX package's branch for its TPU compile relay's "remote compile
    HTTP 500" answers is not carried over: this path has no such relay.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from ..losses import atr_loss, dice_loss, general_union_loss
from ..models.se_unet import SEUNetConfig, _leaves, _tree_map, apply, apply_fast


@dataclasses.dataclass
class TrainState:
    params: Any  # tree of float32 leaf tensors (DHWIO), requires_grad
    optimizer: torch.optim.Optimizer
    step: int = 0


def multistep_lr(base_lr: float, milestones: tuple[int, ...], gamma: float,
                 sched_steps: int) -> float:
    """torch.optim.lr_scheduler.MultiStepLR semantics: the LR after
    `sched_steps` calls to scheduler.step(). The reference drives this
    per EPOCH (once in stage 1, train.py:615; twice per epoch in stages
    2/3, train.py:466+493, 273+305), never per optimizer step."""
    n = sum(1 for m in milestones if m <= sched_steps)
    return base_lr * gamma ** n


def make_optimizer(base_lr: float = 1e-4, milestones: tuple[int, ...] = (60, 90),
                   gamma: float = 0.1, weight_decay: float = 1e-2):
    """AdamW with an externally driven MultiStep LR (reference
    train.py:567-572 + 189-191). Returns (optimizer factory, lr_fn): the
    factory takes the parameter list (`create_train_state` calls it);
    lr_fn(sched_steps) -> lr, for `set_learning_rate`."""
    opt = functools.partial(torch.optim.AdamW, lr=base_lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)

    def lr_fn(sched_steps: int) -> float:
        return multistep_lr(base_lr, milestones, gamma, sched_steps)

    return opt, lr_fn


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the optimizer's learning rate (what torch's scheduler does to
    its param_groups)."""
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


def current_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def create_train_state(params, optimizer) -> TrainState:
    """A TrainState over leaf copies of `params` (a parameter tree, e.g.
    `SEUNet.params_tree()`), with `optimizer` (make_optimizer's factory)
    built over them."""
    leaves = _tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    return TrainState(leaves, optimizer(list(_leaves(leaves))), 0)


def _per_crop_gul(prob, target, weight):
    return torch.stack([general_union_loss(p, t, w) for p, t, w in zip(prob, target, weight)])


def make_loss_fn(cfg: SEUNetConfig = SEUNetConfig(), stage: int = 1, fast: bool = True):
    """loss_fn(params, batch, generator=None, drop_draws=None) ->
    (loss, aux) of one stage, the train-mode forward included.

    Batch dict (float32 tensors on one device, B crops):
      image:  (B, D, H, W, 2) dual-windowed CT
      label:  (B, D, H, W)
      weight: (B, D, H, W)   stages 2/3
      skel:   (B, D, H, W)   stage 3
    """
    apply_fn = apply_fast if fast else apply

    def loss_fn(params, batch, generator=None, drop_draws=None):
        en, de = apply_fn(params, batch["image"], cfg=cfg, train=True,
                          generator=generator, drop_draws=drop_draws)
        p_en = torch.sigmoid(en[..., 0].to(torch.float32))
        p_de = torch.sigmoid(de[..., 0].to(torch.float32))
        label = batch["label"]
        aux = {}
        if stage == 1:
            l_de = dice_loss(p_de, label)
            l_en = dice_loss(p_en, label)
            loss = l_de + l_en
            aux["dice_de"], aux["dice_en"] = l_de, l_en
        else:
            weight = batch["weight"]
            l_de = general_union_loss(p_de, label, weight)
            l_en = general_union_loss(p_en, label, weight)
            loss = l_de + 0.5 * l_en
            aux["gul_de"], aux["gul_en"] = l_de, l_en
            aux["per_crop_gul"] = _per_crop_gul(p_de, label, weight)
            if stage == 3:
                skel = batch["skel"]
                a_en = atr_loss(p_en, skel, weight)
                a_de = atr_loss(p_de, skel, weight)
                loss = loss + 0.5 * (a_en + a_de)
                aux["atr_en"], aux["atr_de"] = a_en, a_de
        aux["loss"] = loss
        return loss, aux

    return loss_fn


def make_train_step(cfg: SEUNetConfig = SEUNetConfig(), stage: int = 1, mesh=None,
                    shard_space: bool = False, fast: bool = True):
    """Build the step of a stage: step(state, batch, rng=None, *,
    drop_draws=None) -> (state, aux). `rng` is the torch.Generator of
    the DropLayer draws, or `drop_draws` gives them; see `make_loss_fn`
    for the batch. The state's parameters and optimizer are updated in
    place. `fast` uses the s2d `apply_fast` path (gradient-equivalent to
    the reference-layout `apply`); `cfg.remat` checkpoints the blocks."""
    if mesh is not None or shard_space:
        raise NotImplementedError("sharded training (mesh, shard_space) is not ported yet")
    loss_fn = make_loss_fn(cfg, stage, fast)

    def step(state: TrainState, batch, rng=None, *, drop_draws=None):
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(state.params, batch, rng, drop_draws)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in aux.items()}

    return step


def make_resilient_step(cfg: SEUNetConfig = SEUNetConfig(), stage: int = 1, mesh=None,
                        shard_space: bool = False, fast: bool = True, _make_step=None):
    """make_train_step plus an out-of-memory fallback: when the step
    raises torch.cuda.OutOfMemoryError, the wrapper rebuilds it with
    `remat=True` (every block but the phased ones checkpointed: a much
    smaller live set), logs the switch, clears the partial gradients and
    retries the same batch. The fallback engages at most once per
    wrapper; a second OOM propagates. A retry draws fresh DropLayer
    numbers from `rng` unless `drop_draws` are given. The parameters
    change only in the optimizer's step, after the backward, where the
    memory peak lies. `_make_step` is an injection point for tests."""
    make = _make_step or make_train_step
    holder = {"fn": make(cfg, stage, mesh, shard_space, fast), "fellback": False}

    def step(state: TrainState, batch, rng=None, **kw):
        try:
            return holder["fn"](state, batch, rng, **kw)
        except torch.cuda.OutOfMemoryError:
            if holder["fellback"]:
                raise
            holder["fellback"] = True
            print("[train] step ran out of device memory; rebuilding with remat=True "
                  "and retrying", flush=True)
            holder["fn"] = make(dataclasses.replace(cfg, remat=True), stage, mesh,
                                shard_space, fast)
            state.optimizer.zero_grad(set_to_none=True)
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            return holder["fn"](state, batch, rng, **kw)

    step.fallback_active = lambda: holder["fellback"]
    return step
