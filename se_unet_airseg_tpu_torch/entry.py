"""Compile-check and dry-run entry points of the port: the counterparts
of the JAX repository's `__graft_entry__.entry()` and
`__graft_entry__.dryrun_multichip()`.

    import torch
    from se_unet_airseg_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()
    print(fn(*args).shape)   # torch.Size([1, 128, 128, 128])
    dryrun_multichip(2)      # 2 ranks over gloo: loss and max |diff|
    dryrun_multichip(4)      # 4 ranks, a (2 data, 2 space) mesh, and the
                             # 128^3 eval forward split over both axes
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .models.se_unet import SEUNet, SEUNetConfig, _leaves, apply_fast
from .utils.devices import resolve_device


def entry(device=None):
    """(fn, args): the bf16 eval forward of the s2d fast path on one
    128^3 tile, batch 1, on `device` (default `cuda`; raises without
    CUDA unless `device="cpu"`), with weights drawn from seed 0.
    `fn(params, x)` returns the decoder head's sigmoid, (1, 128, 128, 128)
    float32."""
    dev = resolve_device(device)
    cfg = SEUNetConfig(compute_dtype=torch.bfloat16)
    model = SEUNet(cfg, generator=torch.Generator().manual_seed(0))
    params = model.to(dev).params_tree()

    @torch.inference_mode()
    def fwd(params, x):
        _, de = apply_fast(params, x, cfg=cfg)
        return torch.sigmoid(de[..., 0].to(torch.float32))

    x = torch.zeros((1, 128, 128, 128, 2), dtype=torch.float32, device=dev)
    return fwd, (params, x)


# the bound JAX's dry run sets on sharded inference (`__graft_entry__.py:99`)
FORWARD_ATOL = 1e-4


def _dryrun(mesh, n: int, device=None) -> dict:
    """The dry run on one rank of `mesh`, or with `mesh=None` in one
    process on `device`: a float32 stage-3 step (AdamW) on the global
    batch of 2n crops of 16^3 (depth split over the mesh's space ranks,
    if more than one), then the runner (cube 32, step 16, batch n) over a
    48x32x32 volume, from seeded weights; when the mesh of n ranks has a
    `space` axis (`_n_space`), then the eval forward of `_forward_section`.
    Returns the loss, the stepped parameters and the step's gradients on
    the CPU, the score volume and the forward's results."""
    from .infer.sliding_window import SlidingWindowRunner
    from .train.step import create_train_state, make_optimizer, make_train_step

    dev = mesh.device if mesh is not None else device
    cfg = SEUNetConfig()
    params = SEUNet(cfg, generator=torch.Generator().manual_seed(0)).to(dev).params_tree()
    opt, _ = make_optimizer()
    state = create_train_state(params, opt)
    rng = np.random.default_rng(0)
    b, s = 2 * n, 16
    batch = {"image": rng.random((b, s, s, s, 2), np.float32),
             "label": (rng.random((b, s, s, s)) > 0.7).astype(np.float32),
             "weight": rng.random((b, s, s, s)).astype(np.float32),
             "skel": (rng.random((b, s, s, s)) > 0.9).astype(np.float32)}
    if mesh is None:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    # float32 means float32: no TF32 in cuDNN's convs (on by default)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        step = make_train_step(cfg, stage=3, mesh=mesh,
                               shard_space=mesh is not None and mesh.space_size > 1)
        state, aux = step(state, batch, torch.Generator(device=dev).manual_seed(1))
        vol = (np.random.default_rng(1).random((48, 32, 32)) * 1000 - 900).astype(np.float32)
        runner = SlidingWindowRunner(params, cfg, cube=32, step=16, batch=n, mesh=mesh,
                                     device=dev)
        out = {"loss": float(aux["loss"]),
               "params": [t.detach().cpu() for t in _leaves(state.params)],
               "grads": [torch.zeros(t.shape) if t.grad is None else t.grad.cpu()
                         for t in _leaves(state.params)],
               "scores": runner.predict_hu(vol)}
        del state, aux, runner
        n_space = _n_space(n)
        if n_space > 1:
            out["forward"] = _forward_section(mesh, n // n_space, dev)
    return out


def _forward_section(mesh, n_data: int, dev: torch.device) -> dict:
    """The counterpart of JAX `__graft_entry__._dryrun_production_shape`:
    the float32 eval forward of the default configuration (weights of
    seed 0) on n_data crops of c^3, c = 128 on a CUDA device and 32 on
    the CPU, the head's sigmoid. On a rank of `mesh` its data row's crop
    and depth slab (`mesh.rows`, `mesh.slab`), the output gathered over
    space and data; with `mesh=None` the whole batch in one process.
    Returns the (n_data, c, c, c) output on the CPU, the forward's
    seconds and the peak device memory in GB (None on the CPU)."""
    from .parallel.mesh import all_gather_rows, all_gather_slabs

    c = 128 if dev.type == "cuda" else 32
    cfg = SEUNetConfig()
    params = SEUNet(cfg, generator=torch.Generator().manual_seed(0)).to(dev).params_tree()
    x = np.random.default_rng(3).random((n_data, c, c, c, 2), np.float32)
    if mesh is not None:
        x = x[mesh.rows(n_data)][:, mesh.slab(c)]
    x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        _, de = apply_fast(params, x, cfg=cfg, space=mesh)
        y = torch.sigmoid(de[..., 0].to(torch.float32))
        if mesh is not None:
            y = all_gather_rows(all_gather_slabs(y, mesh), mesh)
        y = y.cpu()
    return {"y": y, "seconds": time.perf_counter() - t0,
            "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                            if dev.type == "cuda" else None)}


def _n_space(n_ranks: int) -> int:
    """The space ranks of the dry run's mesh (JAX `__graft_entry__.py:57`):
    2 when n_ranks is even and at least 4, else 1."""
    return 2 if n_ranks >= 4 and n_ranks % 2 == 0 else 1


def _grad_leaf_ratio(got: list, ref: list) -> float:
    """The largest |got - ref| / |ref| over the gradient leaves whose norm
    is above 1e-5 of the largest (a conv bias in front of an InstanceNorm
    has a gradient of rounding alone). Adam's first step moves every
    parameter by about lr whatever its gradient, so the step is held by
    its gradients, not its parameters."""
    floor = 1e-5 * max(float(r.norm()) for r in ref)
    return max(float((a - r).norm() / r.norm()) for a, r in zip(got, ref)
               if float(r.norm()) > floor)


def dryrun_multichip(n_ranks: int, device=None) -> dict:
    """A sharded stage-3 step and the sharded runner on `n_ranks` ranks
    (spawned over gloo, each on `device`: default the card, rank r on
    cuda:r modulo the cards; "cpu" for the CPU), against the same in one
    process. As the JAX package's (`__graft_entry__.py:57-67`) the mesh
    is (n_ranks / 2) x 2 with the step's and the runner's depth split
    over `space` when n_ranks is even and at least 4, else n_ranks x 1;
    with the `space` axis, then, the float32 eval forward of
    `_forward_section` on n_ranks / 2 crops of 128^3 (32^3 on the CPU),
    each crop's depth split over space (JAX `__graft_entry__.py:103-187`),
    whose output must be finite and within FORWARD_ATOL of one process's
    (raises otherwise). Prints the loss, the max |diff| of the parameters
    and of the scores, the gradients' largest leaf ratio
    (`_grad_leaf_ratio`) and the forward's, and returns them."""
    from .parallel.mesh import spawn

    dev = resolve_device(device)
    n_space = _n_space(n_ranks)
    devices = [str(dev)] * n_ranks if dev.type != "cuda" else [
        f"cuda:{r % torch.cuda.device_count()}" for r in range(n_ranks)]
    ranks = spawn(_dryrun, n_ranks, n_ranks, devices=devices, n_space=n_space)
    one = _dryrun(None, n_ranks, dev)
    r0 = ranks[0]
    out = {"ranks": n_ranks, "mesh": [n_ranks // n_space, n_space], "loss": r0["loss"],
           "loss_one_process": one["loss"],
           "param_max_abs_diff": max(float((a - b).abs().max())
                                     for a, b in zip(r0["params"], one["params"])),
           "grad_leaf_norm_ratio_max": _grad_leaf_ratio(r0["grads"], one["grads"]),
           "score_max_abs_diff": float(np.abs(r0["scores"] - one["scores"]).max()),
           "ranks_equal": all(torch.equal(a, b) for r in ranks[1:]
                              for a, b in zip(r0["params"], r["params"]))}
    line = (f"dryrun_multichip({n_ranks}): (data, space) mesh ({n_ranks // n_space}x{n_space}) "
            f"on {devices[0]}, loss={out['loss']:.6f} (one process {one['loss']:.6f}), "
            f"max|dparam|={out['param_max_abs_diff']:.3e}, "
            f"grad leaf |d|/|g| <= {out['grad_leaf_norm_ratio_max']:.3e}, "
            f"max|dscore|={out['score_max_abs_diff']:.3e}, ranks equal: {out['ranks_equal']}")
    if n_space > 1:
        y, y1 = r0["forward"]["y"], one["forward"]["y"]
        fwd = {"crop": y.shape[1], "batch": y.shape[0], "dtype": "float32",
               "finite": bool(torch.isfinite(y).all()),
               "max_abs_diff": float((y - y1).abs().max()), "bound": FORWARD_ATOL,
               "mean": float(y.mean()),
               "ranks_equal": all(torch.equal(y, r["forward"]["y"]) for r in ranks[1:]),
               "seconds_ranks": [r["forward"]["seconds"] for r in ranks],
               "seconds_one_process": one["forward"]["seconds"],
               "peak_mem_gb_ranks": [r["forward"]["peak_mem_gb"] for r in ranks],
               "peak_mem_gb_one_process": one["forward"]["peak_mem_gb"]}
        out["forward"] = fwd
        line += (f"; {fwd['crop']}^3 eval forward sharded (data={n_ranks // n_space} x "
                 f"space={n_space}): finite {fwd['finite']}, mean={fwd['mean']:.4f}, "
                 f"max|dy|={fwd['max_abs_diff']:.3e} (bound {FORWARD_ATOL:.0e}), "
                 f"s {max(fwd['seconds_ranks']):.2f} a rank ({fwd['seconds_one_process']:.2f} "
                 f"one process), peak GB a rank {fwd['peak_mem_gb_ranks']}")
    print(line)
    if n_space > 1 and not (out["forward"]["finite"]
                            and out["forward"]["max_abs_diff"] <= FORWARD_ATOL):
        raise AssertionError(f"the sharded {out['forward']['crop']}^3 forward: finite "
                             f"{out['forward']['finite']}, max|dy| "
                             f"{out['forward']['max_abs_diff']:.3e} against one process")
    return out
