"""Device mesh of the port: data parallelism over torch.distributed.

Counterpart of the JAX package's `parallel/mesh.py`. The JAX package runs
one program over a (data, space) mesh of devices and lets XLA insert the
collectives. Here every device has a process of its own (a rank), the
`data` axis is the process group, and the train step and the runner call
the few collectives they need from this module:

  * `all_sum`: a sum over the ranks whose backward is the identity. A
    global-sum loss L = f(S), S = sum_r s_r, formed from it gives rank r
    the gradient f'(S) ds_r/dtheta, and the ranks' gradients add up to the
    one-process gradient (a mean of per-rank Dice ratios would be another
    loss);
  * `all_gather_rows`: every rank's rows, in rank order;
  * `broadcast_tree`: a parameter tree from rank 0;
  * `sum_over_ranks`: a host array summed over the ranks, which gathers
    what work split by case (`DataMesh.cases`) found;
  * `flat` / `unflat`: one bucket for many tensors (one collective);
  * `spawn`: n ranks on one host over gloo, for the tests, `chip_smoke.py`
    and `entry.dryrun_multichip`.

The collectives use `all_reduce`, `broadcast` and `barrier` only (what
gloo offers for CUDA tensors), and `all_gather_into_tensor` on NCCL.

No rank does long work alone while the others wait in a collective:
between the train steps, the predictions, the break priors and the
validations split the cases over the ranks (`DataMesh.cases`), so a
wait lasts about one case's work, far inside the group's timeout
(`DEFAULT_TIMEOUT_S`), whatever the size of the split.

A multi-GPU run is one process per GPU (`torchrun --nproc_per_node=N`)
that calls `make_mesh()` and passes the mesh to the step, the runner,
`StageConfig(mesh=...)` or `PipelineConfig(mesh=...)`.

The `space` axis (the depth of one crop split over devices) is not
ported: each conv of the s2d path, the hand-written kernels included,
would need a halo exchange, and every InstanceNorm statistic and SE pool a
sum over ranks, with their backwards (ROADMAP M9, the `space` axis).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models.se_unet import _leaves

SPACE_AXIS_NOT_PORTED = (
    "the mesh's `space` axis (depth split over devices) is not ported: it needs a halo "
    "exchange around every conv and kernel and reduced norm and SE statistics (ROADMAP M9, "
    "the `space` axis); use the `data` axis"
)
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    space: str = "space"


AXES = MeshAxes()


class DataMesh:
    """The `data` axis of a mesh: this process's rank among the `size`
    ranks of the default process group, and the device it runs on.
    `shape[axis_names[0]]` and `axis_names` read as on a JAX mesh."""

    axis_names = (AXES.data, AXES.space)

    def __init__(self, rank: int, size: int, device: torch.device, backend: str):
        self.rank, self.size, self.device, self.backend = rank, size, device, backend

    @property
    def shape(self) -> dict:
        return {AXES.data: self.size, AXES.space: 1}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of `n` (a multiple of `size`)."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not divide over {self.size} ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def cases(self, n: int) -> range:
        """This rank's cases of `n` split by case: rank, rank + size, ..."""
        return range(self.rank, n, self.size)

    def barrier(self) -> None:
        dist.barrier()


def check_mesh(mesh, shard_space: bool = False) -> None:
    """Raise for what a step or runner cannot take: `shard_space`, or a
    `mesh` that is neither None nor a `DataMesh`."""
    if shard_space:
        raise NotImplementedError(SPACE_AXIS_NOT_PORTED)
    if mesh is not None and not isinstance(mesh, DataMesh):
        raise TypeError(f"mesh must be a DataMesh from make_mesh(), not {type(mesh).__name__}")


def make_mesh(n_data: int | None = None, n_space: int = 1, devices=None, *,
              backend: str | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> DataMesh:
    """This rank's `DataMesh` over the default process group, which is
    initialised from `env://` (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
    as torchrun sets them) with `backend` (default `nccl` with CUDA, `gloo`
    without) and a `timeout_s` on every collective when it does not exist.

    `n_data`, when given, must be the group's size. Each rank runs on
    `devices[rank]` when `devices` names one device per rank (ranks may
    share a card over gloo), else on `cuda:LOCAL_RANK`, or the CPU without
    CUDA. `n_space > 1` raises NotImplementedError."""
    if n_space != 1:
        raise NotImplementedError(SPACE_AXIS_NOT_PORTED)
    local = int(os.environ.get("LOCAL_RANK", 0))
    if devices is None and torch.cuda.is_available():
        torch.cuda.set_device(local)
    if not dist.is_initialized():
        backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout_s))
    elif backend is not None and backend != dist.get_backend():
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    rank, size = dist.get_rank(), dist.get_world_size()
    if n_data is not None and n_data != size:
        raise ValueError(f"n_data={n_data}, but the process group has {size} ranks")
    if devices is not None:
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
    elif torch.cuda.is_available():
        device = torch.device("cuda", local)
    else:
        device = torch.device("cpu")
    return DataMesh(rank, size, device, dist.get_backend())


def batch_sharding(mesh: DataMesh, shard_space: bool = False):
    """The layout of a crop batch (B, D, H, W[, C]) over `data`: a function
    from the global batch array to this rank's rows (`mesh.rows`).
    `shard_space=True` (depth over `space`) raises NotImplementedError."""
    check_mesh(mesh, shard_space)
    return lambda x: x[mesh.rows(x.shape[0])]


def replicated(mesh: DataMesh):
    """The layout of the parameters, of the step's outputs and of a batch
    that does not divide over the ranks: every rank holds all of it."""
    check_mesh(mesh)
    return lambda x: x


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks; its backward is the identity."""
    return _AllSum.apply(x)


def all_gather_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """(size * b, ...): every rank's (b, ...) rows in rank order. Over gloo
    an all_reduce of a zero-filled buffer holding this rank's rows, exact
    up to the sign of a zero."""
    b = x.shape[0]
    out = x.new_empty((mesh.size * b, *x.shape[1:]))
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, x.contiguous())
        return out
    out.zero_()
    out[mesh.rank * b:(mesh.rank + 1) * b] = x
    dist.all_reduce(out)
    return out


def flat(tensors, *extra: float) -> torch.Tensor:
    """One float32 bucket of `tensors`, flattened in order, followed by the
    numbers `extra`."""
    ts = list(tensors)
    dev = ts[0].device
    parts = [t.detach().reshape(-1).to(torch.float32) for t in ts]
    parts.append(torch.tensor(extra, dtype=torch.float32, device=dev))
    return torch.cat(parts)


def unflat(bucket: torch.Tensor, like) -> list[torch.Tensor]:
    """Views of `bucket` shaped as the tensors `like` (what `flat` packed);
    the numbers after them are left out."""
    out, at = [], 0
    for t in like:
        out.append(bucket[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


@torch.no_grad()
def broadcast_tree(tree):
    """Overwrite every float32 leaf of `tree` in place with rank 0's, in
    one broadcast; returns `tree`."""
    leaves = list(_leaves(tree))
    bucket = flat(leaves)
    dist.broadcast(bucket, 0)
    for t, v in zip(leaves, unflat(bucket, leaves)):
        t.copy_(v)
    return tree


def sum_over_ranks(a: np.ndarray, mesh: DataMesh) -> np.ndarray:
    """The float64 sum of the host array `a` over the ranks. Each rank
    fills its own rows and leaves the others 0: the sum then gathers
    them, exactly."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(mesh.device)
    dist.all_reduce(t)
    return t.cpu().numpy()


def _rank_main(rank: int, n: int, tmp: str, devices, threads: int, timeout_s: float, fn,
               args) -> None:
    """One rank of `spawn`: joins the gloo group through a FileStore in
    `tmp`, runs fn(mesh, *args) and saves its result in `tmp`."""
    torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(make_mesh(devices=devices), *args)
        torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, *args, devices=None, threads: int = 1,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run fn(mesh, *args) on `n` new ranks of one host over gloo and
    return their results in rank order. `fn` and `args` are pickled (a
    module-level function). A rank that raises ends every rank and raises
    here; so does a run longer than `timeout_s`, which is also every
    collective's timeout. `devices`: one device per rank (default: the
    CPU, or cuda:rank with CUDA); `threads`: each rank's intra-op threads."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(n, tmp, devices, threads, timeout_s, fn, args), nprocs=n,
            join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{n} ranks of {fn.__name__} ran over {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"), weights_only=False)
                for r in range(n)]
