"""Compile-check and dry-run entry points of the port: the counterparts
of the JAX repository's `__graft_entry__.entry()` and
`__graft_entry__.dryrun_multichip()`.

    import torch
    from se_unet_airseg_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()
    print(fn(*args).shape)   # torch.Size([1, 128, 128, 128])
    dryrun_multichip(2)      # 2 ranks over gloo: loss and max |diff|
    dryrun_multichip(4)      # 4 ranks, a (2 data, 2 space) mesh
"""

from __future__ import annotations

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


def _dryrun(mesh, n: int, device=None):
    """The dry run on one rank of `mesh`, or with `mesh=None` in one
    process on `device`: a float32 stage-3 step (AdamW) on the global
    batch of 2n crops of 16^3 (depth split over the mesh's space ranks,
    if more than one), then the runner (cube 32, step 16, batch n) over a
    48x32x32 volume, from seeded weights. Returns (loss, the stepped
    parameters on the CPU, the score volume)."""
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
    step = make_train_step(cfg, stage=3, mesh=mesh,
                           shard_space=mesh is not None and mesh.space_size > 1)
    state, aux = step(state, batch, torch.Generator(device=dev).manual_seed(1))
    vol = (np.random.default_rng(1).random((48, 32, 32)) * 1000 - 900).astype(np.float32)
    runner = SlidingWindowRunner(params, cfg, cube=32, step=16, batch=n, mesh=mesh, device=dev)
    return (float(aux["loss"]), [t.detach().cpu() for t in _leaves(state.params)],
            runner.predict_hu(vol))


def dryrun_multichip(n_ranks: int, device=None) -> dict:
    """A sharded stage-3 step and the sharded runner on `n_ranks` ranks
    (spawned over gloo, each on `device`: default the card, rank r on
    cuda:r modulo the cards; "cpu" for the CPU), against the same in one
    process. As the JAX package's (`__graft_entry__.py:57-67`) the mesh
    is (n_ranks / 2) x 2 with the step's and the runner's depth split
    over `space` when n_ranks is even and at least 4, else n_ranks x 1.
    Prints the loss and the max |diff| of the parameters and of the
    scores, and returns them."""
    from .parallel.mesh import spawn

    dev = resolve_device(device)
    n_space = 2 if n_ranks >= 4 and n_ranks % 2 == 0 else 1
    devices = [str(dev)] * n_ranks if dev.type != "cuda" else [
        f"cuda:{r % torch.cuda.device_count()}" for r in range(n_ranks)]
    ranks = spawn(_dryrun, n_ranks, n_ranks, devices=devices, n_space=n_space)
    loss1, params1, vol1 = _dryrun(None, n_ranks, dev)
    loss, params, vol = ranks[0]
    out = {"ranks": n_ranks, "mesh": [n_ranks // n_space, n_space], "loss": loss,
           "loss_one_process": loss1,
           "param_max_abs_diff": max(float((a - b).abs().max()) for a, b in zip(params, params1)),
           "score_max_abs_diff": float(np.abs(vol - vol1).max()),
           "ranks_equal": all(torch.equal(a, b) for r in ranks[1:] for a, b in zip(params, r[1]))}
    print(f"dryrun_multichip({n_ranks}): (data, space) mesh ({n_ranks // n_space}x{n_space}) "
          f"on {devices[0]}, "
          f"loss={loss:.6f} (one process {loss1:.6f}), max|dparam|="
          f"{out['param_max_abs_diff']:.3e}, max|dscore|={out['score_max_abs_diff']:.3e}, "
          f"ranks equal: {out['ranks_equal']}")
    return out
