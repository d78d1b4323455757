"""The `space` axis's pieces on depth slabs against one process, on the CPU
over gloo, port only (no JAX).

One spawn of 3 ranks, a (data 1, space 3) mesh, one intra-op thread each
(`parallel.spawn`); ranks 0 and 1 also form a (1, 2) mesh of their own for
the cases that need two slabs. Each rank builds the whole inputs from a
seed, runs the piece on its depth slab and, in the same process, the piece
on the whole tensors (the one-process reference), and returns both; the
tests compare them.

  * `halo` at (lo, hi) = (1, 1), (1, 2), (2, 0), and `space_sum`: the
    forward against the zero-padded tensor's window and the sum; the
    backward (autograd of a random linear functional, a different one on
    every rank) against one process's; `space_sum`'s cotangent is the sum
    of the ranks' (an identity backward would give each rank its own);
  * the slab upsample (`upsample_trilinear`, `upsample_to_s2d`) at scales
    2, 4 and 8 on 2 and 3 slabs, 16 planes on 2 slabs at scale 2 included
    (output 15 samples input 7.26, the next slab's plane 8), forward and
    backward; `resize.slab_matrix` against the whole crop's matrix;
  * each block on slabs, forward and backward against one process: the
    gathered (ec2: block-lifted conv, K1), the grouped dil-2 (ec5, K1),
    the phased (dc5, two inputs, K2 and its backward's K5), the
    reference-layout `_sse_block` (ec8, dilation 2, side upsampled by 4)
    and the CAT blocks (ec33 in s2d, ec93); in float64 where the block
    computes in its input's type (tolerance 1e-9), float32 inside
    InstanceNorm and the upsample (1e-5);
  * K1/K2/K5's plain versions on a depth slab against the cube's slab;
  * what raises: a depth that does not split, `conv_stats` / `conv_epi`
    with `space=` (ROADMAP M9b), a runner cube that does not split;
  * `all_gather_rows` over the default group and `all_gather_slabs` over
    the space group (one `all_gather_into_tensor`, the call NCCL runs):
    bitwise the ranks' parts in order, a -0.0 and NaN payloads included;
  * an error planted in one rank's forward of the depth-sharded step, with
    the groups' timeout cut to GROUP_TIMEOUT_S: every rank raises, within
    a few timeouts, none hangs;
  * an out-of-memory error planted in one rank's forward of
    `make_resilient_step(shard_space=True)` after its first halo
    exchanges, with the same cut: what each rank raises, that no rank
    falls back to remat, that no parameter or AdamW state moves.
"""

import datetime
import time
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _set_pg_timeout

from se_unet_airseg_tpu_torch.infer import SlidingWindowRunner
from se_unet_airseg_tpu_torch.models import SEUNet, SEUNetConfig
from se_unet_airseg_tpu_torch.models import se_unet as pm
from se_unet_airseg_tpu_torch.models.se_unet import _tree_map, apply, apply_fast
from se_unet_airseg_tpu_torch.ops import epilogue_s2d as eps
from se_unet_airseg_tpu_torch.ops.resize import _interp_matrix, slab_matrix, upsample_trilinear
from se_unet_airseg_tpu_torch.ops.s2d import upsample_to_s2d
from se_unet_airseg_tpu_torch.parallel import (
    DataMesh,
    all_gather_rows,
    all_gather_slabs,
    halo,
    space_sum,
    spawn,
)
from se_unet_airseg_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_resilient_step,
    make_train_step,
)

N_SPACE = 3
HALOS = [(1, 1), (1, 2), (2, 0)]
# (global depth, scale, slabs): the 16-plane case samples the next slab's plane
UPSAMPLES = [(6, 2, 3), (6, 4, 3), (6, 8, 3), (16, 2, 2), (4, 4, 2), (4, 8, 2)]
BLOCKS = ["gathered", "dil2", "phased", "standard", "cat_s2d", "cat"]
F64_TOL = dict(rtol=1e-9, atol=1e-9)
F32_TOL = dict(rtol=1e-5, atol=1e-5)  # InstanceNorm and the upsamples compute in float32
GROUP_TIMEOUT_S = 5.0


def _rand(shape, seed, dtype=torch.float64):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


def _slab(t, mesh):
    return t[:, mesh.slab(t.shape[1])]


def _params64():
    tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(7)).params_tree()
    tree = _tree_map(lambda t: t.detach().double(), tree)
    return tree, pm.prepare_fast_params(tree, SEUNetConfig(compute_dtype=torch.float64))


def _block(name, p, fp):
    """(fn(xs, ps, space) -> list of outputs, global inputs, parameters,
    tolerance) of one block."""
    if name == "gathered":
        pre = fp["ec2"]
        return (lambda xs, ps, sp: [pm._sse_block_s2d(dict(zip(("w", "b", "wse"), ps)),
                                                      xs[0], sp)],
                [_rand((1, 6, 4, 4, 64), 1)], [pre["w"], pre["b"], pre["wse"]], F64_TOL)
    if name == "dil2":
        pre = fp["ec5"]
        return (lambda xs, ps, sp: [pm._sse_block_s2d_dil2(
                    {"wgroup": ps[0], "bg": ps[1], "wse": ps[2], "ng": pre["ng"]}, xs[0],
                    space=sp)],
                [_rand((1, 6, 4, 4, 256), 2)], [pre["wgroup"], pre["bg"], pre["wse"]], F64_TOL)
    if name == "phased":
        pre = fp["dc5"]
        return (lambda xs, ps, sp: [pm._sse_block_s2d_phased(
                    dict(zip(("w_all", "b_all", "wse"), ps)), list(xs), space=sp)],
                [_rand((1, 6, 4, 4, 256), 3), _rand((1, 6, 4, 4, 256), 4)],
                [pre["w_all"], pre["b_all"], pre["wse"]], F64_TOL)
    if name == "standard":
        q = p["ec8"]
        keys = [("conv", "w"), ("conv", "b"), ("se0", "w"), ("se1", "w"), ("side", "w"),
                ("side", "b")]

        def standard(xs, ps, sp):
            tree = {}
            for (a, b), t in zip(keys, ps):
                tree.setdefault(a, {})[b] = t
            return list(pm._sse_block(tree, xs[0], dilation=2, up=4, n_gates=2, space=sp))
        return standard, [_rand((1, 6, 4, 4, 64), 5)], [q[a][b] for a, b in keys], F32_TOL
    if name == "cat_s2d":
        return (lambda xs, ps, sp: [pm._cat_block_s2d({"wd": ps[0]}, list(xs), sp)],
                [_rand((1, 6, 4, 4, c), 6 + i) for i, c in enumerate((256, 64, 128))],
                [fp["ec33"]["wd"]], F64_TOL)
    return (lambda xs, ps, sp: [pm._cat_block({"conv": {"w": ps[0]}}, xs[0], sp)],
            [_rand((1, 6, 4, 4, 192), 9)], [p["ec93"]["conv"]["w"]], F32_TOL)


def _fwd_bwd(fn, inputs, params, mesh, space, seed):
    """Outputs, input gradients and parameter gradients of fn under a
    random linear functional; on a mesh of this rank's slabs, the
    parameter gradients summed over the slabs."""
    with torch.no_grad():
        whole = fn(inputs, params, None)
    cut = (lambda t: _slab(t, mesh)) if space is not None else (lambda t: t)
    xs = [cut(x).clone().requires_grad_(True) for x in inputs]
    ps = [p.clone().requires_grad_(True) for p in params]
    outs = fn(xs, ps, space)
    loss = sum((cut(_rand(w.shape, seed + i, w.dtype)) * o).sum()
               for i, (w, o) in enumerate(zip(whole, outs)))
    loss.backward()
    dps = [p.grad for p in ps]
    if space is not None:
        for g in dps:
            dist.all_reduce(g, group=space.space_group)
    return [o.detach() for o in outs], [x.grad for x in xs], dps


def _gather_part(rank: int) -> torch.Tensor:
    """Rank `rank`'s (2, 3, 4) float32 part of the gather check: seeded
    values, a -0.0 and a NaN whose payload names the rank."""
    t = _rand((2, 3, 4), 90 + rank, torch.float32)
    t[0, 0, 0] = -0.0
    t.view(torch.int32)[1, 2, 3] = 0x7FC00000 | (rank + 1)
    return t


def _ops_rank(mesh) -> dict:
    """Every piece on this rank's slab and on the whole, on the (1, 3)
    mesh and, for ranks 0 and 1, the (1, 2) mesh of their own."""
    pair = dist.new_group([0, 1])
    mesh2 = DataMesh(mesh.rank, 2, mesh.device, mesh.backend, space_size=2,
                     space_group=pair) if mesh.rank < 2 else None
    out = {"rank": mesh.rank, "halo": {}, "space_sum": None, "upsample": {}, "blocks": {}}
    part = _gather_part(mesh.rank)
    out["gather"] = {"rows": (all_gather_rows(part, DataMesh(mesh.rank, N_SPACE, mesh.device,
                                                              mesh.backend)),
                              torch.cat([_gather_part(r) for r in range(N_SPACE)])),
                     "slabs": (all_gather_slabs(part, mesh),
                               torch.cat([_gather_part(r) for r in range(N_SPACE)], dim=1))}
    s, nz = mesh.space_rank, 2
    x = _rand((2, nz * N_SPACE, 3, 2, 2), 11)
    for lo, hi in HALOS:
        xl = _slab(x, mesh).clone().requires_grad_(True)
        y = halo(xl, lo, hi, mesh)
        w = _rand(y.shape, 20 + s)
        (w * y).sum().backward()
        # one process: the windows of the zero-padded tensor, every rank's functional
        xw = x.clone().requires_grad_(True)
        padded = torch.nn.functional.pad(xw, (0, 0, 0, 0, 0, 0, lo, hi))
        win = [padded[:, r * nz:r * nz + lo + nz + hi] for r in range(N_SPACE)]
        sum((_rand(y.shape, 20 + r) * v).sum() for r, v in enumerate(win)).backward()
        out["halo"][(lo, hi)] = {"y": (y.detach(), win[s].detach()),
                                 "dx": (xl.grad, _slab(xw.grad, mesh))}
    v = _rand((2, 5), 30 + s).requires_grad_(True)
    total = space_sum(v, mesh)
    (_rand((2, 5), 40 + s) * total).sum().backward()
    parts = [_rand((2, 5), 30 + r) for r in range(N_SPACE)]
    out["space_sum"] = {"y": (total.detach(), sum(parts)),
                        "dx": (v.grad, sum(_rand((2, 5), 40 + r) for r in range(N_SPACE)))}

    for depth, scale, slabs in UPSAMPLES:
        m = mesh if slabs == N_SPACE else mesh2
        if m is None:
            continue
        for kind, up in (("trilinear", upsample_trilinear), ("to_s2d", upsample_to_s2d)):
            fn = (lambda xs, ps, sp, up=up, scale=scale: [up(xs[0], scale, space=sp)])
            xin = _rand((1, depth, 2, 2, 3), 50 + depth + scale)
            got = _fwd_bwd(fn, [xin], [], m, m, 60)
            want = _fwd_bwd(fn, [xin], [], m, None, 60)
            out["upsample"][(kind, depth, scale, slabs)] = (got, want)

    p, fp = _params64()
    for name in BLOCKS:
        fn, inputs, params, tol = _block(name, p, fp)
        got = _fwd_bwd(fn, inputs, params, mesh, mesh, 70)
        want = _fwd_bwd(fn, inputs, params, mesh, None, 70)
        out["blocks"][name] = (got, want, tol)
    return out


def _error_rank(mesh) -> dict:
    """The depth-sharded stage-1 step at 16^3 with rank 1's first phased
    block raising; the groups' timeout cut to GROUP_TIMEOUT_S."""
    cut = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    for g in (None, mesh.space_group):
        _set_pg_timeout(cut, g)
    r = np.random.default_rng(0)
    batch = {"image": r.random((1, 16, 16, 16, 2), np.float32),
             "label": (r.random((1, 16, 16, 16)) > 0.7).astype(np.float32)}
    tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(3)).params_tree()
    state = create_train_state(tree, make_optimizer()[0])
    step = make_train_step(SEUNetConfig(), stage=1, mesh=mesh, shard_space=True)
    real = pm._sse_block_s2d_phased
    mesh.barrier()  # both ranks enter the step together

    def planted(*a, **k):
        if mesh.space_rank == 1:
            raise ValueError("a bad slab (planted)")
        return real(*a, **k)

    t0 = time.perf_counter()
    try:
        with mock.patch.object(pm, "_sse_block_s2d_phased", planted):
            step(state, batch, torch.Generator().manual_seed(1))
        raised = None
    except Exception as e:  # what every rank raised is the result
        raised = (type(e).__name__, str(e)[:200])
    return {"raised": raised, "seconds": time.perf_counter() - t0}


def _oom_rank(mesh) -> dict:
    """make_resilient_step(shard_space=True) on the depth-sharded stage-1
    step at 16^3 with a torch.cuda.OutOfMemoryError raised in rank 1's
    first phased block (after the gathered blocks' halo exchanges) of
    every step it builds; the groups' timeout cut to GROUP_TIMEOUT_S."""
    cut = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    for g in (None, mesh.space_group):
        _set_pg_timeout(cut, g)
    r = np.random.default_rng(0)
    batch = {"image": r.random((1, 16, 16, 16, 2), np.float32),
             "label": (r.random((1, 16, 16, 16)) > 0.7).astype(np.float32)}
    tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(3)).params_tree()
    before = [t.detach().clone() for t in pm._leaves(tree)]
    state = create_train_state(tree, make_optimizer()[0])
    real, built = pm._sse_block_s2d_phased, []

    def planted(*a, **k):
        if mesh.space_rank == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (planted)")
        return real(*a, **k)

    def make(cfg, stage, mesh_, shard_space, fast):
        built.append(cfg.remat)
        inner = make_train_step(cfg, stage, mesh_, shard_space, fast)

        def planted_step(*a, **kw):
            with mock.patch.object(pm, "_sse_block_s2d_phased", planted):
                return inner(*a, **kw)
        return planted_step

    step = make_resilient_step(SEUNetConfig(), stage=1, mesh=mesh, shard_space=True,
                               _make_step=make)
    mesh.barrier()  # both ranks enter the step together
    t0 = time.perf_counter()
    try:
        step(state, batch, torch.Generator().manual_seed(1))
        raised = None
    except Exception as e:  # what every rank raised is the result
        raised = {"type": type(e).__name__, "runtime": isinstance(e, RuntimeError),
                  "oom": isinstance(e, torch.cuda.OutOfMemoryError), "msg": str(e)[:200]}
    return {"raised": raised, "seconds": time.perf_counter() - t0, "built": built,
            "fellback": step.fallback_active(), "step": state.step,
            "adam_state": len(state.optimizer.state),
            "params_unchanged": all(torch.equal(a, b) for a, b in
                                    zip(before, pm._leaves(state.params)))}


@pytest.fixture(scope="module")
def ranks():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield spawn(_ops_rank, N_SPACE, n_space=N_SPACE, timeout_s=300)
    finally:
        torch.set_num_threads(n)


def _close(got, want, tol, what):
    torch.testing.assert_close(got, want, **tol, msg=what)


@pytest.mark.parametrize("kind", ["rows", "slabs"])
def test_gather_is_the_ranks_parts_bitwise(ranks, kind):
    for r in ranks:
        got, want = r["gather"][kind]
        assert got.shape == want.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("lo,hi", HALOS)
def test_halo_forward_and_backward_match_the_padded_tensor(ranks, lo, hi):
    for r in ranks:
        case = r["halo"][(lo, hi)]
        assert torch.equal(*case["y"])  # copies and zero planes, bitwise
        _close(*case["dx"], F64_TOL, f"halo ({lo}, {hi}) backward")


def test_space_sum_backward_is_the_sum_of_the_ranks_cotangents(ranks):
    for r in ranks:
        _close(*r["space_sum"]["y"], F64_TOL, "space_sum forward")
        got, want = r["space_sum"]["dx"]
        _close(got, want, F64_TOL, "space_sum backward")


@pytest.mark.parametrize("depth,scale,slabs", UPSAMPLES)
@pytest.mark.parametrize("kind", ["trilinear", "to_s2d"])
def test_slab_upsample_matches_the_whole_crop(ranks, kind, depth, scale, slabs):
    for r in ranks[:slabs]:
        (y, dx, _), (wy, wdx, _) = r["upsample"][(kind, depth, scale, slabs)]
        _close(y[0], _slab_of(wy[0], r, slabs), F32_TOL, "upsample forward")
        _close(dx[0], _slab_of(wdx[0], r, slabs), F32_TOL, "upsample backward")


def _slab_of(t, rank_out, slabs):
    """The slab of the one-process result `t` that the rank of
    `rank_out` holds (its index on both meshes is its rank)."""
    k = t.shape[1] // slabs
    return t[:, rank_out["rank"] * k:(rank_out["rank"] + 1) * k]


@pytest.mark.parametrize("name", BLOCKS)
def test_block_on_slabs_matches_one_process(ranks, name):
    for r in ranks:
        (outs, dxs, dps), (wouts, wdxs, wdps), tol = r["blocks"][name]
        for o, w in zip(outs, wouts):
            _close(o, _slab_of(w, r, N_SPACE), tol, f"{name} forward")
        for g, w in zip(dxs, wdxs):
            _close(g, _slab_of(w, r, N_SPACE), tol, f"{name} input gradient")
        for g, w in zip(dps, wdps):
            _close(g, w, tol, f"{name} parameter gradient")


@pytest.mark.parametrize("kind", ["gathered_epilogue", "phased_epilogue", "phased_normalize"])
def test_epilogue_plain_versions_on_a_slab_are_the_cubes_slab(kind):
    """K1/K2/K5's plain versions take (B, nz, n, n, 8C) / (B, nz+1, n+1,
    xw, 8C): on planes z0 .. z0+nz of a cube they give the cube's output
    planes z0 .. z0+nz-1."""
    n, nz, z0, c8 = 6, 2, 2, 64
    g = torch.Generator().manual_seed(4)
    y = torch.randn((2, n + 1, n + 1, n + 3, c8), generator=g)
    scale8, shift8 = 0.5 + torch.rand((2, c8), generator=g), torch.randn((2, c8), generator=g)
    wse = 0.1 * torch.randn((2, c8 // 8), generator=g)
    if kind == "gathered_epilogue":
        cube = y[:, :n, :n, :n].contiguous()
        got = eps.gathered_epilogue(cube[:, z0:z0 + nz].contiguous(), scale8, shift8, wse)
        want = eps.gathered_epilogue(cube, scale8, shift8, wse)[:, z0:z0 + nz]
    elif kind == "phased_epilogue":
        got = eps.phased_epilogue(y[:, z0:z0 + nz + 1], scale8, shift8, wse)
        want = eps.phased_epilogue(y, scale8, shift8, wse)[:, z0:z0 + nz]
    else:
        got = eps.phased_normalize(y[:, z0:z0 + nz + 1], scale8, shift8)
        want = eps.phased_normalize(y, scale8, shift8)[:, z0:z0 + nz]
    assert got.shape == (2, nz, n, n, c8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_space", [2, 3, 4])
@pytest.mark.parametrize("n,scale", [(2, 2), (4, 2), (8, 4), (16, 2), (16, 8), (64, 2)])
def test_slab_matrices_are_the_whole_matrix_rows(n, scale, n_space):
    """Each slab's (nz*scale, nz+2) matrix holds its rows of the whole
    crop's align_corners matrix on its planes and one halo plane a side,
    and nothing of a row lies outside that window."""
    nz = n
    whole = np.pad(_interp_matrix(nz * n_space, nz * n_space * scale), ((0, 0), (1, 1)))
    for s in range(n_space):
        m = slab_matrix(nz, scale, n_space, s)
        assert m.shape == (nz * scale, nz + 2)
        rows = whole[s * nz * scale:(s + 1) * nz * scale]
        np.testing.assert_array_equal(m, rows[:, s * nz:s * nz + nz + 2])
        np.testing.assert_array_equal(m.sum(1), rows.sum(1))


def _fake_mesh(space_size=2):
    return DataMesh(0, space_size, torch.device("cpu"), "gloo", space_size=space_size)


def test_a_depth_that_does_not_split_raises():
    tree = SEUNet(SEUNetConfig(), generator=torch.Generator().manual_seed(1)).params_tree()
    mesh = _fake_mesh()
    for fwd in (apply_fast, apply):
        with pytest.raises(ValueError, match="8 x n_space"):
            fwd(tree, torch.zeros((1, 4, 16, 16, 2)), space=mesh)  # 8 planes over 2
        with pytest.raises(ValueError, match="8 x n_space"):
            fwd(tree, torch.zeros((1, 12, 16, 16, 2)), space=mesh)  # 24 planes over 2
    with pytest.raises(ValueError, match="8 x"):
        SlidingWindowRunner(tree, SEUNetConfig(), cube=24, step=12, batch=1, mesh=mesh,
                            device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        mesh.slab(7)


@pytest.mark.parametrize("field", ["conv_stats", "conv_epi"])
def test_conv_stats_and_conv_epi_take_no_depth_slab(field):
    cfg = SEUNetConfig(**{field: True})
    tree = SEUNet(cfg, generator=torch.Generator().manual_seed(1)).params_tree()
    for fwd in (apply_fast, apply):
        with pytest.raises(NotImplementedError, match="M9b"):
            fwd(tree, torch.zeros((1, 8, 16, 16, 2)), cfg=cfg, space=_fake_mesh())


def test_an_error_in_one_ranks_forward_raises_on_every_rank():
    """Rank 1 raises in its first phased block; rank 0 waits in that
    block's halo exchange until the cut timeout, and both leave the step
    raising, within a few timeouts."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = spawn(_error_rank, 2, n_space=2, timeout_s=120)
    finally:
        torch.set_num_threads(n)
    assert out[1]["raised"] is not None and out[0]["raised"] is not None
    assert out[1]["raised"][0] in ("ValueError", "RuntimeError", "DistBackendError")
    for r in out:
        assert r["seconds"] < 6 * GROUP_TIMEOUT_S + 10


def test_an_out_of_memory_error_on_one_space_rank_raises_without_fallback():
    """Rank 1 runs out of memory in its first phased block, after the
    gathered blocks' halo exchanges, and waits in the loss sum; rank 0
    waits in that block's halo exchange. After the cut timeout rank 1
    raises the loss sum's timeout and rank 0 the exchange's timeout or
    closed connection: both RuntimeErrors, neither an out-of-memory
    error, so neither falls back to remat. No parameter moves and AdamW
    takes no step, within a few timeouts."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = spawn(_oom_rank, 2, n_space=2, timeout_s=120)
    finally:
        torch.set_num_threads(n)
    for r in out:
        assert r["raised"] is not None and r["raised"]["runtime"], r["raised"]
        assert not r["raised"]["oom"], r["raised"]
        assert r["built"] == [False] and not r["fellback"]
        assert r["step"] == 0 and r["adam_state"] == 0 and r["params_unchanged"]
        assert r["seconds"] < 6 * GROUP_TIMEOUT_S + 10
