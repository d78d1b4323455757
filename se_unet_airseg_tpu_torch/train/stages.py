"""The three curriculum stage drivers (reference train.py:140-629), on the
port's train step.

Each driver reproduces the reference loop structure:

  stage 1 (reference train.py:516-629): 100 epochs, AdamW 1e-4,
    MultiStepLR [60,90] x0.1, dice_en+dice_de, validation only at the
    final epoch, checkpoint every epoch.
  stage 2 (train.py:328-514): 50 epochs, resume from stage 1, GUL
    losses, online hard-mining cache written per step + a second pass
    over the cached crops each epoch, MultiStepLR [40,60] stepped
    TWICE per epoch (deliberate reference behavior, train.py:466+493),
    validation + curriculum-scheduler feedback every epoch.
  stage 3 (train.py:140-326): same shape as stage 2 plus skeleton
    crops, atr loss, BR weights and the break-ratio scheduler.

Every epoch writes `SE_UNet_<ep>.pt` and a full state (`state_<ep>.pt`,
the two newest kept) with `resume_meta.json` (the scheduler's ratios and
the validation history); a driver restarted on the same
`model_savepath` resumes after the newest state, the JAX drivers'
`state_<ep>.msgpack` included. Drivers take small
injectable configs so tests can run 2-epoch versions on synthetic
volumes.

Counterpart of the JAX package's `train/stages.py`, with these port
choices:
  * Randomness. JAX splits `jax.random.key(cfg.seed)` per step and seeds
    the replay shuffle from it; torch cannot reproduce those streams.
    Every draw the drivers make goes through one `Draws` object: each
    train step's DropLayer draws (`Draws.step`) and the replay shuffle's
    seed (`Draws.shuffle_seed`), from one `torch.Generator(device)`
    seeded with `cfg.seed`. Tests replace `Draws` with one that hands the
    port JAX's draws. The datasets' numpy generators are the same code
    as in JAX, so their crops are identical.
  * Initial parameters. Without `start_params` the drivers use the
    port's seeded init (`SEUNet(cfg, generator=...)`), which differs from
    JAX's `init_params`. `start_params` takes a parameter tree, a `.pt`,
    a reference `.pth` or a JAX `.msgpack` path; the train state holds
    copies of its leaves, so a stage hand-off never aliases the previous
    stage's parameters.
  * The JAX package's TPU memory knob (REMAT_SKIP_WHOLEBLOCK) is not
    carried: the step is `make_resilient_step`, whose out-of-memory
    fallback is `remat=True`. Nor is `StageConfig.validate_every`, which
    no JAX driver reads.
  * Device. `StageConfig.device` (default None: `cuda`, raising without
    CUDA; tests pass "cpu"). Datasets yield numpy batches on the host;
    the driver uploads a copy per step and hands the host arrays, with
    the per-crop losses fetched once per step, to the online cache.

On a mesh (`StageConfig.mesh`, a `parallel.DataMesh`; JAX `stages.py`
:65-74, :146-156, :193-232) every rank runs the driver:
  * every rank builds the same global batch from the seeded datasets (the
    crops of one process) and the sharded step uploads only its rows; the
    replay's B=1 steps run replicated through the same step, or with
    `replay_bucket` in buckets of n_data crops through the sharded step,
    the tail at B=1;
  * rank 0 alone writes (`SE_UNet_<ep>.pt`, `state_<ep>.pt`,
    `resume_meta.json`, the online cache, TensorBoard, the LOG book) and
    prints the loss. A barrier follows the cache's writes before the
    replay reads them, and the driver's last write before it returns;
    every rank resumes from the same newest state;
  * validation splits the val cases over the ranks, each with an
    unsharded runner of its own (`infer.engine.validate(mesh=...)`): each
    case sees the draws of one process, and every rank gets the same
    (td, bd, vr, vh), so the ranks' schedulers and learning rates stay
    equal. The JAX drivers validate on one device while the others idle;
    here no rank waits in a collective through a whole validation.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any

import numpy as np
import torch

from ..data.datasets import OnlineCrops, Prefetcher, Stage1Crops, Stage2Crops, Stage3Crops
from ..data.splits import load_json_file
from ..models.se_unet import SEUNet, SEUNetConfig, _tree_map
from ..parallel.mesh import broadcast_tree, check_mesh
from ..utils.devices import resolve_device
from ..utils.profiling import count, span
from .checkpoint import load_params, load_state, save_params, save_state
from .online_cache import OnlineCache
from .schedule import CurriculumScheduler, Stage3Scheduler
from .step import create_train_state, make_optimizer, make_resilient_step, set_learning_rate
from .tensorboard import SummaryWriter

_SCALARS = ("dice_en", "dice_de", "gul_en", "gul_de", "atr_en", "atr_de")


@dataclasses.dataclass
class StageConfig:
    data_root: str
    file_root: str
    file_path: str
    model_savepath: str
    log_savepath: str
    epochs: int
    batch_size: int = 8
    cube: int = 128
    lr: float = 1e-4
    milestones: tuple = (60, 90)
    aug: bool = True
    seed: int = 777
    online_savepath: str | None = None
    pred_path: str | None = None  # pred_1 (stage 2) / pred_2 (stage 3)
    br_skel_path: str | None = None
    br_weight_path: str | None = None
    start_params: Any = None  # parameter tree or checkpoint path
    mesh: Any = None  # a parallel.DataMesh: data parallelism over its ranks
    model_cfg: SEUNetConfig = dataclasses.field(default_factory=SEUNetConfig)
    # Online-HM replay batching on a mesh. False keeps the reference's
    # sequential B=1 updates (replicated single-crop steps on every rank);
    # True stacks n_data consecutive cached crops per sharded step: a
    # deliberate deviation (one update on the bucket instead of n) that
    # spreads the replay over the ranks. No effect without a mesh.
    replay_bucket: bool = False
    device: Any = None  # None -> cuda, the rank's under a mesh (raises without CUDA)


class Draws:
    """Every random draw of a stage driver, from one torch.Generator on
    `device` seeded with `seed`."""

    def __init__(self, seed: int, device):
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def step(self, batch_size: int) -> dict:
        """Keyword arguments of one train step's DropLayer draws."""
        return {"rng": self.generator}

    def shuffle_seed(self) -> int:
        """The seed of one replay pass's shuffle."""
        g = self.generator
        return int(torch.randint(0, 2**31 - 1, (1,), generator=g, device=g.device))


def _auto_resume(cfg: StageConfig, state):
    """Resume from the newest full state in model_savepath (the recovery
    the reference lacks: its resume is commented-out torch.load lines):
    the port's `state_<ep>.pt` or, from a run of the JAX drivers,
    `state_<ep>.msgpack` (the port's file wins a tie). Returns (state,
    start_epoch, meta), meta carrying scheduler state."""
    paths = [p for ext in ("pt", "msgpack")
             for p in glob.glob(os.path.join(cfg.model_savepath, f"state_*.{ext}"))]
    if not paths:
        return state, 0, {}
    latest = max(paths, key=lambda p: (_epoch_of(p), p.endswith(".pt")))
    ep = _epoch_of(latest)
    state = load_state(latest, state)
    meta_path = os.path.join(cfg.model_savepath, "resume_meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if _is_main(cfg):
        print(f"[resume] continuing from epoch {ep + 1} ({latest})")
    return state, ep + 1, meta


def _epoch_of(path: str) -> int:
    return int(path.split("_")[-1].split(".")[0])


def _save_resume_point(cfg: StageConfig, state, ep: int, meta: dict):
    save_state(state, cfg.model_savepath, ep)
    with open(os.path.join(cfg.model_savepath, "resume_meta.json"), "w") as f:
        json.dump(meta, f)
    # keep only the two newest full states (parameter snapshots are kept
    # every epoch apart, matching the reference cadence)
    paths = sorted(glob.glob(os.path.join(cfg.model_savepath, "state_*.pt")), key=_epoch_of)
    for old in paths[:-2]:
        os.remove(old)


def _is_main(cfg: StageConfig) -> bool:
    """Whether this process writes: the only one, or rank 0 of the mesh."""
    return cfg.mesh is None or cfg.mesh.is_main


def _barrier(cfg: StageConfig) -> None:
    if cfg.mesh is not None:
        cfg.mesh.barrier()


def _init_state(cfg: StageConfig, stage: int, device: torch.device):
    check_mesh(cfg.mesh)
    opt, lr_fn = make_optimizer(base_lr=cfg.lr, milestones=cfg.milestones)
    if cfg.start_params is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        params = SEUNet(cfg.model_cfg, generator=gen).params_tree()
    elif isinstance(cfg.start_params, (str, os.PathLike)):
        params = load_params(os.fspath(cfg.start_params))
    else:
        params = cfg.start_params
    params = _tree_map(lambda t: torch.as_tensor(t).to(device, torch.float32), params)
    # create_train_state copies the leaves: the caller's tree is not
    # updated in place by this stage's optimizer
    state = create_train_state(params, opt)
    if cfg.mesh is not None:
        broadcast_tree(state.params)
    # the online-HM replay feeds batch-size-1 items through the same
    # step (reference DataLoader(batch_size=1), train.py:470-478), which
    # runs them replicated on a mesh
    step_fn = make_resilient_step(cfg.model_cfg, stage=stage, mesh=cfg.mesh)
    return state, step_fn, lr_fn


def _feed(batch: dict, device: torch.device, mesh) -> dict:
    """The step's batch: uploaded to `device` (the span `train.upload`, its
    bytes counted in `train.h2d_bytes`), or on a mesh the host arrays, of
    which the sharded step uploads this rank's rows."""
    if mesh is not None:
        return batch
    with span("train.upload"):
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    count("train.h2d_bytes", sum(t.nbytes for t in out.values()))
    return out


def _epoch_pass(state, step_fn, batches, draws: Draws, device, log_every=10, cache=None,
                cache_limit=0, epoch=0, n_volumes=0, writer=None, mesh=None):
    """The main pass; on a mesh `cache` and `writer` are rank 0's alone
    (None on the other ranks), which also logs."""
    losses = []
    for it, batch in enumerate(batches):
        batch.pop("name", None)
        state, aux = step_fn(state, _feed(batch, device, mesh),
                             **draws.step(batch["image"].shape[0]))
        loss = float(aux["loss"])
        losses.append(loss)
        if cache is not None:
            cache.add_batch(batch, aux["per_crop_gul"].cpu().numpy(), it, cache_limit)
        scalars = {k: float(aux[k]) for k in _SCALARS if k in aux}
        if writer is not None:
            writer.add_scalars("Train", {"loss": loss, **scalars}, it + epoch * n_volumes)
        if it % log_every == 0 and (mesh is None or mesh.is_main):
            parts = [f"epoch: {epoch}", f"iter {it + epoch * n_volumes}", f"loss: {loss:.4f}"]
            parts += [f"{k}: {v:.4f}" for k, v in scalars.items()]
            print(" ".join(parts))
    return state, losses


def _replay_pass(cfg: StageConfig, state, replay, step_fn, draws: Draws, device):
    """Online hard-mining second pass over the epoch's cached crops
    (reference train.py:469-491): one B=1 step per crop, the reference's
    DataLoader(batch_size=1), replicated on a mesh. With
    `cfg.replay_bucket` on a mesh, consecutive crops stack into buckets of
    n_data for the sharded step; the bucket tail runs at B=1."""
    bucket_n = 0
    if cfg.replay_bucket and cfg.mesh is not None:
        bucket_n = int(cfg.mesh.shape[cfg.mesh.axis_names[0]])

    def run(state, items):
        batch = {k: np.stack([np.asarray(it[k], np.float32) for it in items])
                 for k in items[0]}
        state, _ = step_fn(state, _feed(batch, device, cfg.mesh), **draws.step(len(items)))
        return state

    buf = []
    for item in replay:
        item.pop("name", None)
        if bucket_n > 1:
            buf.append(item)
            if len(buf) == bucket_n:
                state, buf = run(state, buf), []
        else:
            state = run(state, [item])
    for item in buf:  # bucket tail: reference-style B=1
        state = run(state, [item])
    return state


def _validate(cfg: StageConfig, params, epoch: int, stage: int, device, dti=False,
              runner=None):
    """The validation's (td, bd, vr, vh); on a mesh every rank validates
    its share of the cases and returns the same values."""
    from ..infer.engine import validate  # the engine imports train.logbook

    names = load_json_file(cfg.file_path, "0", ("val",))
    return validate(
        params, cfg.model_cfg, names, cfg.data_root, cfg.file_root,
        epoch, cfg.log_savepath, dti=dti, stage=stage,
        cube=cfg.cube, step=cfg.cube // 2, runner=runner, device=device, mesh=cfg.mesh,
    )


def _make_val_runner(cfg: StageConfig, params, device):
    """One validation runner per stage: per-epoch validation swaps the
    parameters into it (`set_params`) instead of building a new one."""
    from ..infer.sliding_window import SlidingWindowRunner

    return SlidingWindowRunner(params, cfg.model_cfg, train_mode=True, cube=cfg.cube,
                               step=cfg.cube // 2, device=device)


def _writer(cfg: StageConfig) -> SummaryWriter | None:
    if not _is_main(cfg):
        return None
    return SummaryWriter(os.path.join(os.path.dirname(cfg.log_savepath) or ".", "tb"))


def _save(cfg: StageConfig, state, ep: int, meta: dict) -> None:
    """The epoch's parameter file and resume point, by rank 0 alone."""
    if _is_main(cfg):
        save_params(state.params, cfg.model_savepath, ep)
        _save_resume_point(cfg, state, ep, meta)


def _finish(cfg: StageConfig, writer) -> None:
    """Close the writer; on a mesh every rank returns once rank 0's files
    are written."""
    if writer is not None:
        writer.close()
    _barrier(cfg)


def train_stage1(cfg: StageConfig):
    device = resolve_device(cfg.device, cfg.mesh)
    dataset = Stage1Crops(
        cfg.file_path, cfg.data_root, cfg.file_root,
        batch_size=cfg.batch_size, cube=cfg.cube, aug=cfg.aug, seed=cfg.seed,
    )
    state, step_fn, lr_fn = _init_state(cfg, 1, device)
    writer = _writer(cfg)
    state, start_ep, _ = _auto_resume(cfg, state)
    draws = Draws(cfg.seed, device)
    for ep in range(start_ep, cfg.epochs):
        # MultiStepLR stepped once per epoch after training (reference
        # train.py:615): the count at the START of epoch `ep` is `ep`
        state = set_learning_rate(state, lr_fn(ep))
        state, _ = _epoch_pass(
            state, step_fn, Prefetcher(dataset), draws, device,
            epoch=ep, n_volumes=len(dataset), writer=writer, mesh=cfg.mesh,
        )
        if ep == cfg.epochs - 1:
            # reference __main__ runs stage 1 with DTI=1 (train.py:872)
            # so the final-epoch validation binarizes via hysteresis
            _validate(cfg, state.params, ep, 1, device, dti=True)
        _save(cfg, state, ep, {})
    _finish(cfg, writer)
    return state


def _train_hard_mining(cfg: StageConfig, stage: int, dataset, scheduler):
    """Stages 2 and 3: the epoch pass with the online cache, the replay,
    validation and the scheduler update every epoch."""
    device = resolve_device(cfg.device, cfg.mesh)
    state, step_fn, lr_fn = _init_state(cfg, stage, device)
    writer = _writer(cfg)
    with_skel = stage == 3
    main = _is_main(cfg)
    cache = OnlineCache(cfg.online_savepath, with_skel=with_skel) if main else None
    hist: dict[str, list] = {"tr": [], "th": [], "td": [], "bd": []}
    cache_limit = int(len(dataset) * cfg.batch_size * 0.3)
    state, start_ep, meta = _auto_resume(cfg, state)
    if meta:
        scheduler.hard_ratio = meta.get("hard_ratio", scheduler.hard_ratio)
        if with_skel:
            scheduler.break_ratio = meta.get("break_ratio", scheduler.break_ratio)
        hist = meta.get("hist", hist)
    draws = Draws(cfg.seed, device)
    val_runner = _make_val_runner(cfg, state.params, device)
    for ep in range(start_ep, cfg.epochs):
        if main:
            cache.reset()
        dataset.hard_ratio = scheduler.hard_ratio
        if with_skel:
            dataset.break_ratio = scheduler.break_ratio
        # lr_scheduler.step() fires TWICE per epoch in stages 2/3
        # (reference train.py:466+493, 273+305): the main pass of epoch
        # `ep` runs at scheduler count 2*ep, the replay pass at 2*ep+1
        state = set_learning_rate(state, lr_fn(2 * ep))
        state, _ = _epoch_pass(
            state, step_fn, Prefetcher(dataset), draws, device,
            cache=cache, cache_limit=cache_limit, epoch=ep,
            n_volumes=len(dataset), writer=writer, mesh=cfg.mesh,
        )
        # online hard-mining second pass in shuffled order, like the
        # reference's DataLoader(shuffle=True) over the cached crops
        # (reference train.py:469-491, data.py:586-607)
        state = set_learning_rate(state, lr_fn(2 * ep + 1))
        _barrier(cfg)  # rank 0's cache is complete
        replay = OnlineCrops(cfg.online_savepath, rate=1.0, with_skel=with_skel,
                             shuffle_rng=np.random.default_rng(draws.shuffle_seed()))
        state = _replay_pass(cfg, state, replay, step_fn, draws, device)
        td, bd, vr, vh = _validate(cfg, state.params, ep, stage, device, runner=val_runner)
        hist["td"].append(td)
        hist["bd"].append(bd)
        hist["tr"].append(vr)
        hist["th"].append(vh)
        scheduler.update(ep, hist["tr"], hist["th"], hist["td"], hist["bd"])
        meta = {"hard_ratio": scheduler.hard_ratio}
        if with_skel:
            meta["break_ratio"] = scheduler.break_ratio
        meta["hist"] = hist
        _save(cfg, state, ep, meta)
    _finish(cfg, writer)
    return state


def train_stage2(cfg: StageConfig):
    dataset = Stage2Crops(
        cfg.file_path, cfg.data_root, cfg.file_root, cfg.pred_path,
        batch_size=cfg.batch_size, cube=cfg.cube, aug=cfg.aug, seed=cfg.seed,
    )
    return _train_hard_mining(cfg, 2, dataset, CurriculumScheduler())


def train_stage3(cfg: StageConfig):
    dataset = Stage3Crops(
        cfg.file_path, cfg.data_root, cfg.file_root, cfg.pred_path,
        cfg.br_skel_path, cfg.br_weight_path,
        batch_size=cfg.batch_size, cube=cfg.cube, aug=cfg.aug, seed=cfg.seed,
    )
    return _train_hard_mining(cfg, 3, dataset, Stage3Scheduler())
