"""Device mesh of the port: data and space parallelism over
torch.distributed.

Counterpart of the JAX package's `parallel/mesh.py`. The JAX package runs
one program over a (data, space) mesh of devices and lets XLA insert the
collectives. Here every device has a process of its own (a rank), ranks
form an (n_data, n_space) grid with rank = d * n_space + s (the row-major
order of JAX's `reshape(n_data, n_space)`), and the train step, the model
and the runner call the few collectives they need from this module:

  * `all_sum`: a sum over all ranks whose backward is the identity. A
    global-sum loss L = f(S), S = sum_r s_r, formed from it gives rank r
    the gradient f'(S) ds_r/dtheta, and the ranks' gradients add up to the
    one-process gradient (a mean of per-rank Dice ratios would be another
    loss);
  * `all_gather_rows` / `all_gather_slabs`: every data row's batch rows,
    or every space rank's depth slab, in order;
  * `halo` (the `space` axis): a depth slab with its neighbours' boundary
    planes, the depth padding of a conv;
  * `space_sum` (the `space` axis): a sum over the space ranks whose
    backward is also that sum, for the InstanceNorm statistics;
  * `broadcast_tree`: a parameter tree from rank 0;
  * `sum_over_ranks`: a host array summed over the ranks, which gathers
    what work split by case (`DataMesh.cases`) found;
  * `flat` / `unflat`: one bucket for many tensors (one collective);
  * `spawn`: n ranks on one host over gloo, for the tests, `chip_smoke.py`
    and `entry.dryrun_multichip`.

The collectives are `all_reduce`, `broadcast`, `barrier` and, for
`all_gather_rows` and `all_gather_slabs`, `all_gather_into_tensor` in
its concatenated form: one call on every backend, gloo and NCCL alike.

The `space` axis splits the depth of each crop over the n_space ranks of
a data row: rank (d, s) holds planes [s D/n_space, (s+1) D/n_space) of
the crops of row d. Every conv takes its depth padding from `halo`, every
InstanceNorm adds its statistics with `space_sum`, and the loss sums and
the gradients add over all ranks as under `data`. Nothing else of this
model reduces over space: its SE gates are per-voxel 1x1x1 gates
(`models/se_unet.py::_SSEConv`), DropLayer draws per (crop, channel), the
pools and space-to-depth stay inside a slab of even depth.

No rank does long work alone while the others wait in a collective:
between the train steps, the predictions, the break priors and the
validations split the cases over the ranks (`DataMesh.cases`), so a
wait lasts about one case's work, far inside the group's timeout
(`DEFAULT_TIMEOUT_S`), whatever the size of the split.

A multi-GPU run is one process per GPU (`torchrun --nproc_per_node=N`)
that calls `make_mesh()` (or `make_mesh(n_space=2)`) and passes the mesh
to the step, the runner, `StageConfig(mesh=...)` or
`PipelineConfig(mesh=...)`.
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

DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    space: str = "space"


AXES = MeshAxes()


class DataMesh:
    """An (n_data, n_space) mesh of the default process group's `size`
    ranks: this process's `rank`, its data row `data_rank` and space rank
    `space_rank` (rank = data_rank * space_size + space_rank), the device
    it runs on, and the process groups of its data column (`data_group`,
    fixed space rank) and of its space row (`space_group`, fixed data
    rank). With space_size 1 the data group is the default group (None)
    and there is no space group. `shape` and `axis_names` read as on a JAX
    mesh."""

    axis_names = (AXES.data, AXES.space)

    def __init__(self, rank: int, size: int, device: torch.device, backend: str,
                 space_size: int = 1, data_group=None, space_group=None):
        if space_size < 1 or size % space_size:
            raise ValueError(f"{size} ranks do not split into space rows of {space_size}")
        self.rank, self.size, self.device, self.backend = rank, size, device, backend
        self.space_size, self.data_size = space_size, size // space_size
        self.data_rank, self.space_rank = divmod(rank, space_size)
        self.data_group, self.space_group = data_group, space_group

    @property
    def shape(self) -> dict:
        return {AXES.data: self.data_size, AXES.space: self.space_size}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of `n` (a multiple of `data_size`):
        those of its data row."""
        if n % self.data_size:
            raise ValueError(f"a batch of {n} does not divide over {self.data_size} data rows")
        k = n // self.data_size
        return slice(self.data_rank * k, (self.data_rank + 1) * k)

    def slab(self, n: int) -> slice:
        """This rank's depth slab of `n` planes (a multiple of `space_size`)."""
        if n % self.space_size:
            raise ValueError(f"a depth of {n} does not divide over {self.space_size} space ranks")
        k = n // self.space_size
        return slice(self.space_rank * k, (self.space_rank + 1) * k)

    def cases(self, n: int) -> range:
        """This rank's cases of `n` split by case: rank, rank + size, ..."""
        return range(self.rank, n, self.size)

    def barrier(self) -> None:
        dist.barrier()


def check_mesh(mesh, shard_space: bool = False) -> None:
    """Raise for what a step or runner cannot take: a `mesh` that is
    neither None nor a `DataMesh` (TypeError), or `shard_space` without a
    mesh (ValueError; the JAX package ignores the flag there)."""
    if mesh is not None and not isinstance(mesh, DataMesh):
        raise TypeError(f"mesh must be a DataMesh from make_mesh(), not {type(mesh).__name__}")
    if shard_space and mesh is None:
        raise ValueError("shard_space=True needs a mesh (make_mesh(n_space=...))")


def make_mesh(n_data: int | None = None, n_space: int = 1, devices=None, *,
              backend: str | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> DataMesh:
    """This rank's `DataMesh` over the default process group, which is
    initialised from `env://` (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
    as torchrun sets them) with `backend` (default `nccl` with CUDA, `gloo`
    without) and a `timeout_s` on every collective when it does not exist.

    The group's ranks form n_data x n_space (default n_data: all ranks
    over `n_space`); `n_data`, when given, must match. With n_space > 1
    every rank creates, in the same order, one group per space row and
    one per data column, with the same timeout. Each rank runs on
    `devices[rank]` when `devices` names one device per rank (ranks may
    share a card over gloo), else on `cuda:LOCAL_RANK`, or the CPU without
    CUDA."""
    if n_space < 1:
        raise ValueError(f"n_space must be at least 1, got {n_space}")
    local = int(os.environ.get("LOCAL_RANK", 0))
    if devices is None and torch.cuda.is_available():
        torch.cuda.set_device(local)
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    elif backend is not None and backend != dist.get_backend():
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    rank, size = dist.get_rank(), dist.get_world_size()
    if size % n_space or (n_data is not None and n_data * n_space != size):
        raise ValueError(f"n_data={n_data} x n_space={n_space}, but the process group has "
                         f"{size} ranks")
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
    data_group = space_group = None
    if n_space > 1:
        rows = size // n_space
        d, s = divmod(rank, n_space)
        for r in range(rows):
            g = dist.new_group([r * n_space + k for k in range(n_space)], timeout=timeout)
            space_group = g if r == d else space_group
        for k in range(n_space):
            g = dist.new_group([r * n_space + k for r in range(rows)], timeout=timeout)
            data_group = g if k == s else data_group
    return DataMesh(rank, size, device, dist.get_backend(), n_space, data_group, space_group)


def batch_sharding(mesh: DataMesh, shard_space: bool = False):
    """The layout of a crop batch (B, D, H, W[, C]) over the mesh: a
    function from the global batch array to this rank's rows
    (`mesh.rows`) and, with `shard_space`, its depth slab (`mesh.slab`)."""
    check_mesh(mesh)

    def lay(x):
        x = x[mesh.rows(x.shape[0])]
        return x[:, mesh.slab(x.shape[1])] if shard_space else x
    return lay


def replicated(mesh: DataMesh, shard_space: bool = False):
    """The layout of the parameters, of the step's outputs and of a batch
    that does not divide over the data rows: every rank holds all of it;
    with `shard_space` a crop batch's depth is still split over space
    (JAX `step.py:205-215`)."""
    check_mesh(mesh)
    return (lambda x: x[:, mesh.slab(x.shape[1])]) if shard_space else (lambda x: x)


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


def _gather(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """(n * x.shape[0], ...): the `x` of the n ranks of `group`, in the
    order of their index in it, concatenated along axis 0, bitwise. One
    `all_gather_into_tensor` in the concatenated form, which gloo and NCCL
    both take (gloo refuses the stacked (n, *x.shape) form)."""
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def all_gather_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """(data_size * b, ...): the (b, ...) rows of every data row, in order
    (over the data group: the ranks of this rank's space index)."""
    return _gather(x, mesh.data_size, mesh.data_group)


def all_gather_slabs(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """(b, space_size * k, ...): the (b, k, ...) depth slab of every space
    rank of this data row, in order along axis 1."""
    if mesh.space_size == 1:
        return x
    out = _gather(x, mesh.space_size, mesh.space_group).view(mesh.space_size, *x.shape)
    return out.movedim(0, 1).reshape(x.shape[0], -1, *x.shape[2:])


def _space_reduce(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """`t` (contiguous) summed in place over the space ranks of this data
    row; returns it."""
    if mesh.space_size > 1:
        dist.all_reduce(t, group=mesh.space_group)
    return t


def _exchange_planes(buf: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """buf (space_size, k), row `space_rank` this rank's part, the other
    rows zero -> every space rank's part in its row, bitwise: a uint8 sum
    over the space row (on gloo and NCCL alike), each byte having one
    writer. It moves space_size times the two neighbour blocks a rank
    needs (ROADMAP Queue 2: a neighbour send/receive)."""
    dist.all_reduce(buf.view(torch.uint8), group=mesh.space_group)
    return buf


def _neighbours(to_prev: torch.Tensor, to_next: torch.Tensor, mesh: DataMesh):
    """Every space rank s sends `to_prev` to rank s-1 and `to_next` to rank
    s+1, in one exchange that every rank of the row joins; returns
    (from_prev, from_next), what s-1 sent forward (shaped as `to_next`)
    and what s+1 sent back (shaped as `to_prev`), zeros at the ends."""
    s, n = mesh.space_rank, mesh.space_size
    a = to_prev.numel()
    if n == 1 or a + to_next.numel() == 0:
        return to_next.new_zeros(to_next.shape), to_prev.new_zeros(to_prev.shape)
    buf = to_prev.new_zeros((n, a + to_next.numel()))
    buf[s, :a] = to_prev.reshape(-1)
    buf[s, a:] = to_next.reshape(-1)
    buf = _exchange_planes(buf, mesh)
    from_prev = buf[s - 1, a:].view(to_next.shape) if s > 0 else \
        to_next.new_zeros(to_next.shape)
    from_next = buf[s + 1, :a].view(to_prev.shape) if s < n - 1 else \
        to_prev.new_zeros(to_prev.shape)
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, mesh):
        ctx.lo, ctx.hi, ctx.mesh = lo, hi, mesh
        nz = x.shape[1]
        prev_tail, next_head = _neighbours(x[:, :hi], x[:, nz - lo:], mesh)
        return torch.cat([prev_tail, x, next_head], dim=1)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.lo, ctx.hi
        nz = g.shape[1] - lo - hi
        dx = g[:, lo:lo + nz].clone()
        from_prev, from_next = _neighbours(g[:, :lo], g[:, lo + nz:], ctx.mesh)
        dx[:, :hi] += from_prev
        dx[:, nz - lo:] += from_next
        return dx, None, None, None


def halo(x: torch.Tensor, lo: int, hi: int, mesh: DataMesh) -> torch.Tensor:
    """(B, lo + nz + hi, ...): the depth slab x (B, nz, ...) of this space
    rank with the previous rank's last `lo` planes before it and the next
    rank's first `hi` planes after it, along axis 1; zero planes at the
    crop's two ends, which is a conv's zero padding. Every rank of the
    space row must call it with the same lo and hi (each exchange is one
    collective of the row; a rank that skips one deadlocks the others).

    Adjoint: the cotangent of the lo halo planes goes back to the previous
    rank and is added to the cotangent of its last lo planes; that of the
    hi planes to the next rank, added to its first hi planes; the halo's
    cotangent at the crop's ends (the zero planes) is dropped."""
    if lo == hi == 0:
        return x
    if x.shape[1] < max(lo, hi):
        raise ValueError(f"a halo of ({lo}, {hi}) planes needs slabs of at least "
                         f"{max(lo, hi)} planes, got {x.shape[1]}")
    return _Halo.apply(x, lo, hi, mesh)


class _SpaceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _space_reduce(x.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return _space_reduce(g.contiguous().clone(), ctx.mesh), None


def space_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum of `x` over the space ranks of this data row (a statistic
    of the crops' whole depth from each slab's part of it).

    Adjoint: the sum over the space ranks too. The statistic's value is
    the same on every space rank, but what each rank computes from it
    covers its own slab only, so each rank's cotangent of the statistic
    holds only its slab's part; their sum is the whole cotangent, which
    every slab's share of the statistic receives. (`all_sum`'s identity
    backward is right for the loss, which every rank forms whole.)"""
    if mesh.space_size == 1:
        return x
    return _SpaceSum.apply(x, mesh)


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
    from ..models.se_unet import _leaves

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


def _rank_main(rank: int, n: int, tmp: str, devices, threads: int, timeout_s: float,
               n_space: int, fn, args) -> None:
    """One rank of `spawn`: joins the gloo group through a FileStore in
    `tmp`, runs fn(mesh, *args) and saves its result in `tmp`."""
    torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(make_mesh(n_space=n_space, devices=devices, timeout_s=timeout_s), *args)
        torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, *args, devices=None, threads: int = 1,
          timeout_s: float = DEFAULT_TIMEOUT_S, n_space: int = 1) -> list:
    """Run fn(mesh, *args) on `n` new ranks of one host over gloo and
    return their results in rank order. `fn` and `args` are pickled (a
    module-level function). A rank that raises ends every rank and raises
    here; so does a run longer than `timeout_s`, which is also every
    collective's timeout. `devices`: one device per rank (default: the
    CPU, or cuda:rank with CUDA); `threads`: each rank's intra-op threads;
    `n_space`: the mesh's space ranks (a data row's, n / n_space rows)."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(n, tmp, devices, threads, timeout_s, n_space, fn, args), nprocs=n,
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
