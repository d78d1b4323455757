"""Stage-1 training steps through the stage drivers' epoch pass.

The state, step and optimizer are the ones `train_stage1` makes (AdamW at
the mix's `lr`, `make_resilient_step(stage=1)`), fed by the epoch pass
(`_epoch_pass`), which uploads each batch and ends each step at the loss's
host fetch. DropLayer's draws come from the benchmark's own generator. The
mix file sets `source`:
  * `disk`: set-up writes `cases` seeded phantom cases of the given shapes
    under the run's TMPDIR in the training layout (gzip NIfTI CT and mask,
    float16 LIB weight, a split file) and the window reads them through
    `Prefetcher(Stage1Crops(...))`, one epoch after another, as
    `train_stage1` does: one host thread loads, crops, augments and windows
    each volume's batch while the card steps;
  * `resident`: set-up cuts `pool` batches from seeded phantom cases of the
    given shapes with the benchmark's plain copy of the stage-1 crops, held
    on the host; the window cycles through them.
and `batch`, `cube`, `lr`, `trace_steps` (the profiled slice after the
window).

Set-up runs the first three steps one at a time through the same epoch pass
and keeps the first gradient (from AdamW's first moment after one step)
and the parameters after three; the plain float32 reference then follows
the same three steps from the same weights, batches and draws (for `disk`
it cuts the batches again from the files with its own copy of the crops and
the same seed), and so does the reference with its convs in bfloat16, the
configuration's precision. Compared (the cell's `checks` file names which):
the worst step's loss gap; the median leaf's first-gradient norm gap over
the bf16 reference's (`grad_gap_vs_bf16`: random weights set how much a
seed's gradients cancel, and that factor divides out); the median leaf's
gap of the three steps' change; for `disk` the batches themselves. The
worst leaves' gaps are printed on standard error.
"""

from __future__ import annotations

import itertools
import os
import shutil
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .. import counts, program
from ..harness import Check, Outcome, Record, log
from ..reference import stage1_data
from ..reference.seunet import make_adamw, no_tf32, stage1_grads
from ..reference.spec import make_weights

CHECKED_STEPS = 3
FLOOR_GAP = 1e-3  # the unit's floor, for seeds whose bf16 reference reads a smaller gap
BETA1 = 0.9  # AdamW's first-moment decay: exp_avg = (1 - BETA1) * grad after one step


class Draws:
    """DropLayer's uniform draws of each step, from a generator on the
    device seeded with the run's seed; the first CHECKED_STEPS kept."""

    def __init__(self, seed: int, device, side: int):
        self.gen = torch.Generator(device=device).manual_seed(seed % 2**63)
        self.device, self.side, self.kept = device, side, []

    def step(self, batch_size: int) -> dict:
        r = [torch.rand((batch_size, k * self.side), generator=self.gen, device=self.device)
             for k in (12, 6)]
        if len(self.kept) < CHECKED_STEPS:
            self.kept.append([t.clone() for t in r])
        return {"drop_draws": r}


class Feed:
    """The batches handed to the epoch pass: stops before the next batch
    once `deadline` (host clock) has passed or `limit` batches were handed
    out, times each wait on the source, and keeps the first `keep` batches."""

    def __init__(self, source, deadline=None, limit=None, keep=0):
        self.source, self.deadline, self.limit, self.keep = source, deadline, limit, keep
        self.waits, self.kept, self.count = [], [], 0

    def __iter__(self):
        while self.limit is None or self.count < self.limit:
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                return
            t = time.perf_counter()
            with record_function("portbench.data_wait"):
                item = next(self.source, None)
            if item is None:
                return
            self.waits.append(time.perf_counter() - t)
            if len(self.kept) < self.keep:
                self.kept.append({k: v for k, v in item.items() if k != "name"})
            self.count += 1
            yield item


def _epochs(dataset):
    """Endless batches: one Prefetcher epoch after another, each started when
    the one before it ends (as `train_stage1` runs its epochs)."""
    while True:
        yield from program.Prefetcher(dataset)


def _cases(ctx, gen, dev):
    """(name, stored int16, label uint8, LIB float32) of the mix's cases."""
    out = []
    for i, shape in enumerate(ctx.mix["cases"]):
        stored, lumen = counts.phantom(shape, gen, dev)
        lib = stage1_data.lib_weight(lumen).cpu().numpy()
        out.append((f"case{i:02d}", stored, lumen.to(torch.uint8).cpu().numpy(), lib))
    return out


def _disk_source(ctx, cases):
    root = os.path.join(ctx.scratch or ".", "portbench", ctx.workload)
    shutil.rmtree(root, ignore_errors=True)
    for name, stored, label, lib in cases:
        stage1_data.write_case(root, name, stored, label, lib)
    split = os.path.join(root, "split.json")
    stage1_data.write_split(split, [c[0] for c in cases])
    m = ctx.mix
    dataset = program.Stage1Crops(split, root, root, batch_size=m["batch"], cube=m["cube"],
                                  aug=True, seed=ctx.seed)
    return root, _epochs(dataset)


def _resident_pool(ctx, cases):
    rng = np.random.default_rng(ctx.seed)
    pool = []
    for k in range(ctx.mix["pool"]):
        _, stored, label, lib = cases[k % len(cases)]
        hu = stored.astype(np.float32) - 1024.0
        pool.append(stage1_data.volume_batch(hu, label, lib.astype(np.float16), rng,
                                             ctx.mix["batch"], ctx.mix["cube"]))
    return pool


def _norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def _leaf_gaps(got: dict, ref: dict, names) -> dict:
    """|got - ref| / max(ref, the median leaf's ref) of each leaf of `names`."""
    med = float(np.median([ref[n] for n in names]))
    return {n: abs(got[n] - ref[n]) / max(ref[n], med) for n in names}


class Program:
    """The program's training state as `train_stage1` builds it, from the
    weights the benchmark made, with the epoch pass that drives it."""

    def __init__(self, cfg, mix: dict, sd: dict, draws: Draws, dev):
        tree = program.params_from_state_dict(sd)
        self.names = program.leaf_names(tree, sd)
        # sd's own tensors in the program's layout: the starting parameters
        self.theta0 = {self.names[p]: t for p, t in program.walk(tree)}
        opt, lr_fn = program.make_optimizer(base_lr=mix["lr"])
        self.state = program.set_learning_rate(program.create_train_state(tree, opt), lr_fn(0))
        self.step_fn = program.make_resilient_step(cfg, stage=1)
        self.draws, self.dev = draws, dev

    def epoch_pass(self, feed) -> list:
        self.state, losses = program._epoch_pass(self.state, self.step_fn, feed, self.draws,
                                                 self.dev, log_every=10**9)
        return losses

    def checked_steps(self, source):
        """The first CHECKED_STEPS steps one at a time: (losses, the first
        gradient and the parameters after the steps by leaf name, the
        batches)."""
        leaves = dict(program.walk(self.state.params))
        opt_state = self.state.optimizer.state
        losses, grad1, kept = [], {}, []
        for k in range(CHECKED_STEPS):
            feed = Feed(source, limit=1, keep=1)
            losses += self.epoch_pass(feed)
            kept += feed.kept
            if k == 0:
                # a leaf the loss does not reach (dc62's) has no gradient and no state
                grad1 = {self.names[p]: (opt_state[t]["exp_avg"] / (1 - BETA1)
                                         if t in opt_state else torch.zeros_like(t))
                         for p, t in leaves.items()}
        theta = {self.names[p]: t.detach().clone() for p, t in leaves.items()}
        return losses, grad1, theta, kept


def run(ctx) -> Outcome:
    mix, dev = ctx.mix, torch.device(ctx.device)
    cfg = program.model_config(ctx.config)
    sd = make_weights(ctx.seed, dev, cfg.in_channels, cfg.side_channels, cfg.n_classes)
    draws = Draws(ctx.seed, dev, cfg.side_channels)
    prog = Program(cfg, mix, sd, draws, dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed % 2**63)
    cases = _cases(ctx, gen, dev)
    root = None
    if mix["source"] == "disk":
        root, source = _disk_source(ctx, cases)
    else:
        pool = _resident_pool(ctx, cases)
        source = itertools.cycle(pool[CHECKED_STEPS:] + pool[:CHECKED_STEPS])
        source = itertools.chain(pool[:CHECKED_STEPS], source)

    log("weights, state and inputs made")
    # set-up: the checked steps one at a time, then the rest of the warm-up
    losses, grad1, theta, kept = prog.checked_steps(source)
    prog.epoch_pass(Feed(source, limit=mix["warmup_steps"]))
    if dev.type == "cuda":
        torch.cuda.synchronize()

    log("checked and warm-up steps done; window starts")
    t_start = time.perf_counter()
    feed = Feed(source, deadline=t_start + ctx.seconds)
    prog.epoch_pass(feed)
    t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    rec = Record(kind="train", setup_s=t_start - ctx.t0, window_s=t_end - t_start,
                 peak_bytes=peak, crop=mix["cube"], batch=mix["batch"],
                 work={"steps": feed.count, "crops": feed.count * mix["batch"]},
                 spans={"data_wait": feed.waits})

    log(f"window: {feed.count} steps in {t_end - t_start:.3f} s")
    if ctx.trace:
        from ..trace import SLICE, Trace

        program.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(SLICE):
                prog.epoch_pass(Feed(source, limit=mix["trace_steps"]))
                torch.cuda.synchronize()
        rec.trace = Trace.from_profiler(prof, ctx.scratch)
        rec.slice_work = {"steps": mix["trace_steps"], "launches": dict(program.launch_counts)}

        log("profiled slice read")
    # the check, after the window and the memory peak
    theta0, prog = prog.theta0, None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = []
    if root is not None:
        ref_batches = stage1_data.epoch_batches(root, [c[0] for c in cases],
                                                np.random.default_rng(ctx.seed), mix["batch"],
                                                mix["cube"], CHECKED_STEPS)
        diff = max(float(np.max(np.abs(a[k] - b[k]))) for a, b in zip(kept, ref_batches)
                   for k in ("image", "label", "weight"))
        checks.append(Check("batch_max_diff", diff, ctx.limits["batch_max_diff"]))
        shutil.rmtree(root, ignore_errors=True)
    else:
        ref_batches = kept
    checks += compare(sd, theta0, ref_batches, draws.kept, losses, grad1, theta, dev,
                      {n: v for n, v in ctx.limits.items() if n != "batch_max_diff"})
    log("reference steps done")
    return Outcome(attempted=feed.count, failed=0, record=rec, checks=checks)


def reference_steps(sd: dict, batches, drop, dev, quant=None, rows=None):
    """The plain reference's CHECKED_STEPS steps from the weights `sd`:
    (losses, first gradient by leaf, parameters after the steps). `rows`
    keeps only those crops of each batch (a fault: part of the batch left
    out)."""
    params = {n: t.detach().clone().requires_grad_(True) for n, t in sd.items()}
    opt = make_adamw(list(params.values()))
    losses, grad1 = [], {}
    sel = slice(None) if rows is None else rows
    with no_tf32():
        for k, (batch, dr) in enumerate(zip(batches, drop)):
            opt.zero_grad(set_to_none=True)
            image = torch.from_numpy(np.ascontiguousarray(batch["image"][sel])).to(dev)
            label = torch.from_numpy(np.ascontiguousarray(batch["label"][sel])).to(dev)
            losses.append(stage1_grads(params, image, label, [d[sel] for d in dr],
                                       quant=quant, rows_per_block=2))
            if k == 0:
                grad1 = {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                         for n, p in params.items()}
            opt.step()
    return losses, grad1, {n: p.detach() for n, p in params.items()}


def numbers(sd, theta0, losses, grad1, theta, ref, unit=None) -> dict:
    """The numbers of a run's losses, first gradient and parameters after the
    checked steps (`theta0` the starting parameters in the run's layout)
    against the float32 reference's `ref`, each with where it was read: the
    worst step's loss gap; the gaps of the gradient's and the change's norms
    by the worst leaf and by the median leaf; with `unit` (the numbers of the
    reference's own bf16-conv steps) the median leaf's gradient gap in units
    of the unit's. Leaves whose reference gradient is under a thousandth of
    the median leaf's (a conv bias in front of an InstanceNorm, which the
    norm cancels; dc62, which feeds nothing) move by round-off alone and are
    left out of the gradient and the change."""
    r_loss, r_grad1, r_theta = ref
    g_ref, g_got = _norms(r_grad1), _norms(grad1)
    med = float(np.median(list(g_ref.values())))
    moved = [n for n in g_ref if g_ref[n] >= 1e-3 * med]
    d_ref = _norms({n: r_theta[n] - sd[n] for n in moved})
    d_got = _norms({n: theta[n] - theta0[n] for n in moved})
    out = {"loss_gap": max((abs(a - b) / abs(b), f"step {k + 1}")
                           for k, (a, b) in enumerate(zip(losses, r_loss)))}
    for name, got, ref_n in (("grad", g_got, g_ref), ("change", d_got, d_ref)):
        gaps = _leaf_gaps(got, ref_n, moved)
        out[f"{name}_gap"] = max((v, n) for n, v in gaps.items())
        out[f"{name}_gap_median"] = (float(np.median(list(gaps.values()))), "median leaf")
    if unit is not None:
        bf16 = unit["grad_gap_median"][0]
        out["grad_gap_vs_bf16"] = (out["grad_gap_median"][0] / max(bf16, FLOOR_GAP),
                                   f"median leaf over the bf16 reference's {bf16!r}")
    return out


def compare(sd, theta0, batches, drop, losses, grad1, theta, dev, limits) -> list:
    ref = reference_steps(sd, batches, drop, dev)
    unit = numbers(sd, sd, *reference_steps(sd, batches, drop, dev, quant="bf16"), ref)
    got = numbers(sd, theta0, losses, grad1, theta, ref, unit)
    for n, (v, where) in got.items():
        log(f"{n} {v!r} at {where}")
    return [Check(n, got[n][0], limits[n]) for n in limits]
