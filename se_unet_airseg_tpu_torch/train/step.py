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

Under a mesh (`parallel.make_mesh`; JAX `step.py:195-233`) every rank
runs the step on its data row's rows [d*B/n, (d+1)*B/n) of the global
batch (`step.place`), with `shard_space` on its depth slab s of them
(rank (d, s) of an (n_data, n_space) mesh), and the step's outputs are
global on every rank:
  * the loss is a ratio of global sums (`losses.py`): one `all_sum`
    over all ranks, whose backward is the identity, adds the ranks' sums,
    with the per-crop GUL's sums of every crop in its global place (a
    ratio taken on one slab would be another quantity); the ranks'
    gradients then add up to the one-process gradient, in one all_reduce
    over all ranks of one bucket (1,520,314 float32 parameters in 117
    leaves, 6.1 MB), each slab adding its share. Under a profiler session
    (`utils.profiling`) the loss sum is the span `mesh.loss_sum`, the
    bucket's all_reduce with the read of the ranks' status after it
    `mesh.grad_reduce`, and `place`'s upload `train.upload` with its bytes
    in the counter `train.h2d_bytes`;
  * with `shard_space` the forward runs on depth slabs (`apply_fast(...,
    space=mesh)`): halo exchanges around the convs and InstanceNorm sums
    over the space ranks, in the forward and in the backward (remat
    replays them; every rank replays the same blocks in the same order).
    Without it a mesh with n_space > 1 runs each data row's batch
    replicated over space, and space rank 0's sums and gradients count;
  * DropLayer's scale sums its mask over the whole batch, so every rank
    draws the global (B, .) uniforms from the same seeded generator (or
    takes the global `drop_draws`) and uses its own rows of them;
  * a batch that does not divide over the data rows (the online
    hard-mining replay's B=1) runs replicated over data (still split over
    space with `shard_space`, as JAX's `crop_sharding`): data row 0's
    sums and gradients stand for all, so the ranks stay bitwise equal;
  * every rank reaches both collectives of a step whatever it raised,
    and the gradient bucket carries each rank's status: when any rank
    failed, every rank raises before the optimizer step, with the
    parameters unchanged. A rank re-raises its own error, the others a
    RuntimeError, so no rank waits out the group's timeout; when every
    failure was an out-of-memory error, each rank raises one and
    `make_resilient_step` rebuilds and retries on all of them together.
    With `shard_space` the forward and backward themselves hold
    collectives: a rank that fails inside them leaves its space row in
    an exchange, which fails at the group's timeout (gloo raises, and
    the step carries on to its collectives as above; NCCL's watchdog
    ends the process), so every rank raises within a few timeouts and
    none hangs.

Counterpart of the JAX package's `train/step.py`, with these
differences:
  * The parameters are a tree of leaf tensors that the step updates in
    place; the torch optimizer, a stateful object, lives in the
    `TrainState`, so the step builders take no optimizer argument.
  * Under a mesh the JAX package turns its Pallas kernels off
    (`step.py:139-151`), since XLA cannot partition a single-device
    program. Each rank of the port runs a single-device program of its
    own, so the port's kernels stay on (under `shard_space` the default
    configuration's: K1, K2, K5 and K6 take depth slabs; `conv_stats` and
    `conv_epi` raise, ROADMAP M9b).
  * `shard_space=True` without a mesh raises ValueError (the JAX package
    ignores the flag there).
  * `make_resilient_step` falls back on `torch.cuda.OutOfMemoryError`.
    The JAX package's branch for its TPU compile relay's "remote compile
    HTTP 500" answers is not carried over: this path has no such relay.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.distributed as dist

from ..losses import (
    atr_sums,
    dice_from_sums,
    dice_sums,
    general_union_loss,
    general_union_sums,
    union_from_sums,
)
from ..models.se_unet import SEUNetConfig, _leaves, _tree_map, apply, apply_fast, draw_dropout
from ..parallel.mesh import all_sum, batch_sharding, check_mesh, flat, replicated, unflat
from ..utils.profiling import count, span


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


def _stage_sums(stage: int, p_en, p_de, batch) -> list[tuple]:
    """The sums of the stage's losses, in the order `_stage_losses` reads
    them: dice(de), dice(en); or GUL(de), GUL(en)[, atr(en), atr(de)]."""
    label = batch["label"]
    if stage == 1:
        return [dice_sums(p_de, label), dice_sums(p_en, label)]
    weight = batch["weight"]
    sums = [general_union_sums(p_de, label, weight), general_union_sums(p_en, label, weight)]
    if stage == 3:
        sums += [atr_sums(p_en, batch["skel"], weight), atr_sums(p_de, batch["skel"], weight)]
    return sums


_N_SUMS = {1: (3, 3), 2: (2, 2), 3: (2, 2, 2, 2)}  # each loss's sums, per stage


def _stage_losses(stage: int, sums) -> tuple:
    """(loss, aux) of the stage from its losses' sums."""
    if stage == 1:
        l_de, l_en = dice_from_sums(sums[0]), dice_from_sums(sums[1])
        return l_de + l_en, {"dice_de": l_de, "dice_en": l_en}
    l_de, l_en = union_from_sums(sums[0]), union_from_sums(sums[1])
    loss = l_de + 0.5 * l_en
    aux = {"gul_de": l_de, "gul_en": l_en}
    if stage == 3:
        a_en, a_de = union_from_sums(sums[2]), union_from_sums(sums[3])
        loss = loss + 0.5 * (a_en + a_de)
        aux["atr_en"], aux["atr_de"] = a_en, a_de
    return loss, aux


def _heads(apply_fn, cfg: SEUNetConfig, params, image, **draws):
    """The two heads' probabilities in float32, train mode."""
    en, de = apply_fn(params, image, cfg=cfg, train=True, **draws)
    return torch.sigmoid(en[..., 0].to(torch.float32)), torch.sigmoid(de[..., 0].to(torch.float32))


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
        p_en, p_de = _heads(apply_fn, cfg, params, batch["image"], generator=generator,
                            drop_draws=drop_draws)
        loss, aux = _stage_losses(stage, _stage_sums(stage, p_en, p_de, batch))
        if stage > 1:
            aux["per_crop_gul"] = _per_crop_gul(p_de, batch["label"], batch["weight"])
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
    the reference-layout `apply`); `cfg.remat` checkpoints the blocks.

    With a `mesh` (a `parallel.DataMesh`) the step takes the global batch
    (numpy arrays or tensors on any device), uploads this rank's rows
    (`step.place`; with `shard_space` their depth slab) and returns the
    global aux on every rank; see the module docstring. `shard_space`
    without a mesh raises ValueError."""
    check_mesh(mesh, shard_space)
    if mesh is not None:
        return _make_sharded_step(cfg, stage, mesh, fast, shard_space)
    loss_fn = make_loss_fn(cfg, stage, fast)

    def step(state: TrainState, batch, rng=None, *, drop_draws=None):
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(state.params, batch, rng, drop_draws)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in aux.items()}

    return step


def _make_sharded_step(cfg: SEUNetConfig, stage: int, mesh, fast: bool, shard_space: bool):
    apply_fn = apply_fast if fast else apply
    n_sums = sum(_N_SUMS[stage])
    space = mesh if shard_space else None

    def place(batch, device=None) -> dict:
        """This rank's rows of each batch key (all of them when the batch
        does not divide over the data rows) and, with `shard_space`, their
        depth slab, as tensors on `device` (default the mesh's); JAX
        `step.py:205-228`. The span `train.upload`, its bytes counted in
        `train.h2d_bytes`, as `stages._feed` off the mesh."""
        b = batch["image"].shape[0]
        lay = (batch_sharding if b % mesh.data_size == 0 else replicated)(mesh, shard_space)
        with span("train.upload"):
            out = {k: torch.as_tensor(lay(v)).to(device or mesh.device) for k, v in batch.items()}
        count("train.h2d_bytes", sum(t.nbytes for t in out.values()))
        return out

    def local_sums(params, local, draws, rows, b):
        """This rank's loss sums and, for stages 2/3, its crops' GUL sums
        in their global places of a zero-filled (b, 2), as one vector."""
        p_en, p_de = _heads(apply_fn, cfg, params, local["image"], drop_draws=draws,
                            drop_rows=rows, space=space)
        parts = [torch.stack(s) for s in _stage_sums(stage, p_en, p_de, local)]
        if stage > 1:
            per_crop = p_de.new_zeros((b, 2))
            per_crop[rows] = torch.stack([
                torch.stack(general_union_sums(p, t, w))
                for p, t, w in zip(p_de, local["label"], local["weight"])]).detach()
            parts.append(per_crop.reshape(-1))
        return torch.cat(parts)

    def step(state: TrainState, batch, rng=None, *, drop_draws=None):
        b = batch["image"].shape[0]
        sharded = b % mesh.data_size == 0
        rows = mesh.rows(b) if sharded else slice(None)
        if drop_draws is None:
            if rng is None:
                raise ValueError("the train step needs rng= or drop_draws= for DropLayer")
            drop_draws = draw_dropout(b, cfg, rng)
        leaves = list(_leaves(state.params))
        dev = leaves[0].device
        state.optimizer.zero_grad(set_to_none=True)
        # replicated over data (over space without shard_space): every rank
        # computes the whole batch (its whole depth) and row 0's (slab 0's) counts
        share = float((sharded or mesh.data_rank == 0)
                      and (shard_space or mesh.space_rank == 0))
        error = None
        try:
            local = place(batch, dev)
            vec = local_sums(state.params, local, drop_draws, rows, b) * share
        except Exception as e:  # every rank must still reach both collectives
            error = e
            vec = torch.zeros(n_sums + (2 * b if stage > 1 else 0), device=dev)
        with span("mesh.loss_sum"):
            total = all_sum(vec)
        parts = list(torch.split(total[:n_sums], _N_SUMS[stage]))
        loss, aux = _stage_losses(stage, [p.unbind() for p in parts])
        if error is None:
            try:
                loss.backward()
            except Exception as e:
                error = e
        grads = [t.grad for t in leaves]
        oom = isinstance(error, torch.cuda.OutOfMemoryError)
        bucket = flat([torch.zeros_like(t) if error is not None or g is None else g
                       for t, g in zip(leaves, grads)], float(error is not None), float(oom))
        with span("mesh.grad_reduce"):
            dist.all_reduce(bucket)
            n_failed, n_oom = int(bucket[-2].item()), int(bucket[-1].item())
        if n_failed:
            state.optimizer.zero_grad(set_to_none=True)
            if error is not None and not oom:
                raise error
            if n_failed > n_oom:
                raise RuntimeError(f"{n_failed - n_oom} of {mesh.size} ranks failed in the "
                                   f"step (this is rank {mesh.rank})")
            raise torch.cuda.OutOfMemoryError(
                f"{n_failed} of {mesh.size} ranks ran out of device memory in the step "
                f"(this is rank {mesh.rank})")
        for t, g, v in zip(leaves, grads, unflat(bucket, leaves)):
            t.grad = None if g is None else v
        state.optimizer.step()
        state.step += 1
        if stage > 1:
            aux["per_crop_gul"] = union_from_sums(total[n_sums:].reshape(b, 2).unbind(1))
        aux["loss"] = loss
        return state, {k: v.detach() for k, v in aux.items()}

    step.place = place
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
    memory peak lies. Under a mesh every rank raises the error when any
    rank ran out of memory, so all ranks fall back and retry together.
    Under `shard_space` that joint fallback holds only when every rank
    of a space row runs out of memory at the same exchange: a rank that
    fails alone inside the forward or backward waits in the loss sum
    while the others of its row wait in a halo exchange, each until the
    group's timeout; then every rank raises a RuntimeError that is not an
    out-of-memory error (the loss sum's timeout on the failed rank, the
    exchange's timeout or closed connection on the others), none falls
    back, and no parameter or optimizer state moves
    (tests/test_torch_space_ops.py). `_make_step` is an injection point
    for tests."""
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
