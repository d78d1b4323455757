"""Stage-1 training steps on the mesh's `data` axis: one rank a card over
NCCL, the global batch split over the ranks.

The run's process is rank 0; it starts ranks 1 .. `ranks` - 1 as processes
of its own (`spawn`), each on its card (`cuda:<rank>`), joined by
`torch.distributed` at a free localhost port. Every rank builds the
program's mesh (`parallel.make_mesh(n_data=ranks)`), the training state
and step of `train_stage1` on a mesh (AdamW at the mix's `lr`,
`make_resilient_step(stage=1, mesh=mesh)`) and runs the stage drivers' epoch
pass (`_epoch_pass(..., mesh=mesh)`) over the same global batches: rank 0
cuts the mix's `pool` batches as `train_stage1`'s resident source does and
broadcasts them at set-up, with the weights, and the sharded step uploads
each rank's rows (`step.place`). DropLayer's draws come from the same
seeded generator on every rank (compared at set-up).

Set-up runs the checked steps one at a time and the warm-up, timing each on
rank 0, which then fixes the window's number of steps from their median and
the run's `--seconds` and hands it to every rank before the window: the
window holds the program's collectives only. Rank 0 times the window, and
profiles the slice after it (the other ranks step alongside). Then every
rank's memory peak is reduced to the largest, the other ranks end, and rank
0 compares: the resident cell's numbers (`train_stage1.compare`: the float32
reference of one process on the global batches and draws, and its bf16
version as the unit) and `rank_param_diff`, the largest difference between
a rank's parameters and rank 0's after the checked steps.

Mix keys: those of `train_stage1`'s `resident` source and `ranks`.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import socket
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from .. import harness, program
from ..harness import Check, Outcome, Record, log
from ..reference.spec import make_weights
from . import train_stage1
from .train_stage1 import CHECKED_STEPS, Draws, Feed

TIMEOUT_S = 300.0  # every collective's, and the wait for the other ranks at the end
KEYS = ("image", "label", "weight")


class MeshProgram(train_stage1.Program):
    """`train_stage1.Program` with the step and epoch pass of a mesh."""

    def __init__(self, cfg, mix: dict, sd: dict, draws: Draws, mesh):
        super().__init__(cfg, mix, sd, draws, mesh.device)
        self.mesh = mesh
        self.step_fn = program.make_resilient_step(cfg, stage=1, mesh=mesh)

    def epoch_pass(self, feed) -> list:
        self.state, losses = program._epoch_pass(self.state, self.step_fn, feed, self.draws,
                                                 self.dev, log_every=10**9, mesh=self.mesh)
        return losses


def _broadcast(t: torch.Tensor) -> torch.Tensor:
    dist.broadcast(t, 0)
    return t


def _pool(ctx, mesh) -> list:
    """The mix's batches, cut on rank 0 and broadcast (host arrays on every
    rank)."""
    m, dev = ctx.mix, mesh.device
    if mesh.rank == 0:
        gen = torch.Generator(device=dev).manual_seed(ctx.seed % 2**63)
        pool = train_stage1._resident_pool(ctx, train_stage1._cases(ctx, gen, dev))
    else:
        c, b = m["cube"], m["batch"]
        shape = {"image": (b, c, c, c, 2), "label": (b, c, c, c), "weight": (b, c, c, c)}
        pool = [{k: np.empty(shape[k], np.float32) for k in KEYS} for _ in range(m["pool"])]
    return [{k: _broadcast(torch.from_numpy(batch[k]).to(dev)).cpu().numpy() for k in KEYS}
            for batch in pool]


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])


def _rank_max(x: float, dev) -> float:
    t = torch.tensor([x], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _param_diff(prog: MeshProgram) -> float:
    """The largest |parameter - rank 0's| over the parameters and the ranks."""
    mine = _flat(t for _, t in program.walk(prog.state.params))
    zero = _broadcast(mine.clone())
    return _rank_max(float((mine - zero).abs().max()), mine.device)


def _draws_diff(draws: Draws) -> float:
    mine = _flat(t for step in draws.kept for t in step)
    return _rank_max(float((mine - _broadcast(mine.clone())).abs().max()), mine.device)


def rank_steps(mesh, ctx):
    """One rank's part of the run on `mesh`; rank 0 returns the Outcome,
    the others None."""
    mix, dev, main = ctx.mix, mesh.device, mesh.rank == 0
    cfg = program.model_config(ctx.config)
    sd = make_weights(ctx.seed, dev, cfg.in_channels, cfg.side_channels, cfg.n_classes)
    for name in sorted(sd):
        _broadcast(sd[name])
    draws = Draws(ctx.seed, dev, cfg.side_channels)
    prog = MeshProgram(cfg, mix, sd, draws, mesh)
    pool = _pool(ctx, mesh)
    source = itertools.chain(pool[:CHECKED_STEPS],
                             itertools.cycle(pool[CHECKED_STEPS:] + pool[:CHECKED_STEPS]))
    if main:
        log(f"rank 0 of {mesh.size}: weights, state and batches made")

    # set-up: the checked steps one at a time, then the warm-up, each timed
    times = []

    def timed(feed):
        t = time.perf_counter()
        out = prog.epoch_pass(feed)
        times.append(time.perf_counter() - t)
        return out

    losses, kept = [], []
    leaves = dict(program.walk(prog.state.params))
    opt_state = prog.state.optimizer.state
    grad1 = {}
    for k in range(CHECKED_STEPS):
        feed = Feed(source, limit=1, keep=1)
        losses += timed(feed)
        kept += feed.kept
        if k == 0:
            grad1 = {prog.names[p]: (opt_state[t]["exp_avg"] / (1 - train_stage1.BETA1)
                                     if t in opt_state else torch.zeros_like(t))
                     for p, t in leaves.items()}
    theta = {prog.names[p]: t.detach().clone() for p, t in leaves.items()}
    rank_diff = _param_diff(prog)
    draws_diff = _draws_diff(draws)
    if draws_diff != 0:
        raise RuntimeError(f"the ranks drew DropLayer numbers apart by {draws_diff!r}")
    for _ in range(mix["warmup_steps"]):
        timed(Feed(source, limit=1))
    step_s = statistics.median(times[1:])
    n = torch.tensor([max(1, math.ceil(ctx.seconds / step_s))], device=dev)
    n = int(_broadcast(n).item())
    if dev.type == "cuda":
        torch.cuda.synchronize()

    if main:
        log(f"checked and warm-up steps done ({step_s:.4f} s a step); window of {n} steps starts")
    t_start = time.perf_counter()
    feed = Feed(source, limit=n)
    prog.epoch_pass(feed)
    t_end = time.perf_counter()
    b = mix["batch"]
    rec = Record(kind="train", setup_s=t_start - ctx.t0, window_s=t_end - t_start,
                 peak_bytes=0, crop=mix["cube"], batch=b,
                 work={"steps": feed.count, "crops": feed.count * b, "ranks": mesh.size},
                 spans={"data_wait": feed.waits})
    if main:
        log(f"window: {feed.count} steps in {t_end - t_start:.3f} s")
    if ctx.trace:
        from ..trace import SLICE, Trace

        trace_feed = Feed(source, limit=mix["trace_steps"])
        if main:
            program.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function(SLICE):
                    prog.epoch_pass(trace_feed)
                    torch.cuda.synchronize()
            rec.trace = Trace.from_profiler(prof, ctx.scratch)
            rec.slice_work = {"steps": mix["trace_steps"],
                              "launches": dict(program.launch_counts)}
            log("profiled slice read")
        else:
            prog.epoch_pass(trace_feed)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec.peak_bytes = int(_rank_max(float(peak), dev))
    if not main:
        return None
    # the check, on rank 0 alone
    theta0, prog = prog.theta0, None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    limits = {k: v for k, v in ctx.limits.items() if k != "rank_param_diff"}
    checks = train_stage1.compare(sd, theta0, kept, draws.kept, losses, grad1, theta, dev,
                                  limits)
    log(f"rank_param_diff {rank_diff!r} over {mesh.size} ranks")
    checks.append(Check("rank_param_diff", rank_diff, ctx.limits["rank_param_diff"]))
    log("reference steps done")
    return Outcome(attempted=feed.count, failed=0, record=rec, checks=checks)


def _rank_main(rank: int, size: int, init: str, fields: dict, child: bool):
    """Rank `rank` of the run: joins the NCCL group at `init`, builds the
    mesh and runs `rank_steps`."""
    if child:
        os.dup2(2, 1)  # the result line is rank 0's alone on standard output
    os.environ["LOCAL_RANK"] = str(rank)
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=init, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = program_mesh(size)
        return rank_steps(mesh, harness.Context(**fields))
    finally:
        dist.destroy_process_group()


def program_mesh(size: int):
    """The program's mesh of `size` data rows over the group just joined."""
    from se_unet_airseg_tpu_torch.parallel import make_mesh

    return make_mesh(n_data=size, timeout_s=TIMEOUT_S)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(ctx) -> Outcome:
    size = ctx.mix["ranks"]
    init = f"tcp://localhost:{_free_port()}"
    fields = {f.name: getattr(ctx, f.name) for f in dataclasses.fields(ctx)}
    spawn = torch.multiprocessing.get_context("spawn")
    procs = [spawn.Process(target=_rank_main, args=(r, size, init, fields, True), daemon=True)
             for r in range(1, size)]
    for p in procs:
        p.start()
    try:
        out = _rank_main(0, size, init, fields, False)
    finally:
        for p in procs:
            p.join(timeout=TIMEOUT_S)
            if p.is_alive():
                p.kill()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks ended with exit codes {bad}")
    return out
