"""Fused s2d convolutions of the Pallas conv kernels
(`SEUNetConfig.conv_stats` and `SEUNetConfig.conv_epi`).

Counterparts of the JAX package's `phased_conv_stats`, `dil2_conv_stats`,
`dil2_conv_stats_bm` and `phased_conv_ext_bm` (`ops/pallas_s2d.py:1081`,
`:404`, `:1714`, `:2179`), built and bound by `ops/cuda_lib.py`. In bf16,
`phased_conv_stats`, `dil2_dense_conv_stats` and `phased_conv_ungathered`
are the three epilogue forms of one wgmma implicit GEMM
(`csrc/conv_wgmma.cu`), which reads the weight K-major and walks a table
of k-steps (`kstep_table`): the phased conv stats over the (n+1)^3 grid
with the phase gather in its epilogue (its rule is `phase_scatter_plain`),
the dense conv skipping the k-steps whose weight tile is all zeros (its
rule is `block_sparse_ksteps_plain`). `dil2_conv_stats` in bf16 is a
persistent halo-brick wgmma kernel (`csrc/dil2_wgmma.cu`) that keeps the
shared dil-2 weight in shared memory, stages each haloed input brick once
and reads its A operand from the brick through the wgmma descriptors (its
rule is `dil2_brick_plain`, its tile `dil2_tile`). Every form in float32 is one FMA kernel
(`csrc/conv_stats.cu`). The three
statistics forms return the conv output y together with its per-lane sums
s1 = sum(y) and s2 = sum(y^2) over the voxels, f32, taken before y is
rounded:

  * `phased_conv_stats(xs, w_all, b_all)`: the pad-1 3^3 conv of the
    full-resolution grid on its s2d fold, as the phase-stacked 2^3 block
    conv (`s2d.phased_conv_weights`) with the 8 phase windows gathered;
    `xs` is one tensor or two forming a plain channel concat, which the
    kernel reads through two pointers;
  * `dil2_conv_stats(x, w, b)`: the dilation-2 3^3 conv on the s2d fold,
    8 independent dil-1 convs with the reference (3, 3, 3, Ci, Co) kernel;
  * `dil2_dense_conv_stats(x, wd, bg)`: the dense pad-1 3^3 conv of an s2d
    tensor with any (3, 3, 3, C8, C8o) kernel (the model passes the
    block-diagonal `s2d.dil2_dense_weight`);
  * `phased_conv_ungathered(xs, w_all, b_all)`: the phased 2^3 block conv
    to its UNGATHERED (n+1)^3 output, bias optional (None: zeros), no
    sums (the conv of `s2d.phased_conv_ext`, rounded once).

Each takes its plain PyTorch version (`*_plain`) for a CPU tensor only; on
a CUDA tensor it launches the kernel or raises. The plain versions compute
the conv in f32 from the operands (f64 for f64 inputs) and round y once,
the kernel's rounding points. Each counts its launches in
`cuda_lib.launch_counts`. Under autograd each is a
`torch.autograd.Function` that saves its inputs only; its backward is
autograd of the plain version (the custom vjps of pallas_s2d.py:1095-1101
and :416-422).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .conv import conv3d
from .cuda_lib import _DTYPE_CODE, F32, _acc, _on_card, _stream, launch
from .s2d import from_polyphase, phase_windows, phased_conv_ext, to_polyphase


def _with_sums(y: torch.Tensor, dtype: torch.dtype):
    """(y rounded to dtype, s1, s2): the sums from y before rounding."""
    return y.to(dtype), y.sum(dim=(1, 2, 3)), torch.square(y).sum(dim=(1, 2, 3))


# ----------------------------------------------------------- plain versions


def phased_conv_stats_plain(xs, w_all, b_all):
    """Plain PyTorch version of `phased_conv_stats`: the 2^3 block conv
    with padding 1 (list partial sums), the 8 phase windows of its
    (n+1)^3 output gathered, the sums; conv and sums in f32."""
    xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
    dt = xs[0].dtype
    acc = _acc(dt)
    w = w_all.reshape(2, 2, 2, *w_all.shape[1:]).to(acc)
    y_ext = phased_conv_ext([t.to(acc) for t in xs], w, b_all.to(acc))
    return _with_sums(torch.cat(phase_windows(y_ext), dim=-1), dt)


def phase_scatter_plain(y_ext, n: int, co: int):
    """The bf16 `phased_conv_stats` kernel's epilogue rule, row by row:
    row v' of the ungathered output y_ext (B, n+1, n+1, n+1, 8Co), column
    j of phase q = j // co = (a, b, c), lands on y[v' - q] where every
    axis of v' - q lies in [0, n), and only those values enter the sums.
    Returns y (B, n^3, 8Co) in y_ext's dtype and the f32 sums s1, s2
    (B, 8Co); the same function as the 8 phase windows of y_ext."""
    b, m, c8 = y_ext.shape[0], n + 1, 8 * co
    v = torch.arange(m ** 3)
    q = torch.arange(c8) // co
    dst = []
    for axis, bit in ((v // (m * m), 2), ((v // m) % m, 1), (v % m, 0)):
        dst.append(axis[:, None] - ((q[None, :] >> bit) & 1))  # (m^3, 8Co)
    ok = torch.stack([(d >= 0) & (d < n) for d in dst]).all(0)
    rows = (dst[0] * n + dst[1]) * n + dst[2]
    cols = torch.arange(c8).expand_as(rows)
    ye = y_ext.reshape(b, m ** 3, c8).float()
    y = torch.zeros((b, n ** 3, c8), dtype=y_ext.dtype)
    y[:, rows[ok], cols[ok]] = ye[:, ok].to(y_ext.dtype)
    kept = ye * ok
    return y, kept.sum(1), torch.square(kept).sum(1)


def dil2_conv_stats_plain(x, w, b):
    """Plain PyTorch version of `dil2_conv_stats`: to_polyphase, the dil-1
    3^3 conv with padding 1, from_polyphase, the sums; in f32."""
    acc = _acc(x.dtype)
    y = conv3d(to_polyphase(x.to(acc)), w.to(acc), b.to(acc), padding=1)
    return _with_sums(from_polyphase(y), x.dtype)


def dil2_dense_conv_stats_plain(x, wd, bg):
    """Plain PyTorch version of `dil2_dense_conv_stats`: the dense 3^3
    conv with padding 1 and the sums; in f32."""
    acc = _acc(x.dtype)
    return _with_sums(conv3d(x.to(acc), wd.to(acc), bg.to(acc), padding=1), x.dtype)


def phased_conv_ungathered_plain(xs, w_all, b_all=None):
    """Plain PyTorch version of `phased_conv_ungathered`: the f32
    `phased_conv_ext` (list partial sums), rounded once."""
    xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
    dt = xs[0].dtype
    acc = _acc(dt)
    b = None if b_all is None else b_all.to(acc)
    return phased_conv_ext([t.to(acc) for t in xs], w_all.to(acc), b).to(dt)


# ------------------------------------------------- the wgmma k-step table

_BK = 64  # lanes of one k-step of the wgmma kernel
_WGMMA_FORM = {"phased_conv_stats": 0, "phased_conv_ungathered": 1, "dil2_dense_conv_stats": 2}
# the last dense launch's plan: column tile "bn", k-steps "nsteps" of each
# column tile, and "count" (C8o / BN,), the k-steps each executed (a device
# tensor, read without a sync)
dense_tiles: dict = {}


def kstep_table(taps: int, widths) -> torch.Tensor:
    """The wgmma kernel's k-steps over `taps` taps of the plain concat of
    inputs `widths` lanes wide, in ascending K order (K = tap * Cin + lane
    of the concat): one int32 entry tap | input << 5 | valid << 6 | first
    lane << 13 per 64 lanes of one tap of one input; `valid` < 64 lanes at
    an input's end, the rest zero-filled."""
    return torch.tensor([t | i << 5 | min(_BK, c - l0) << 6 | l0 << 13
                         for t in range(taps) for i, c in enumerate(widths)
                         for l0 in range(0, c, _BK)], dtype=torch.int32)


def kstep_fields(entries: torch.Tensor):
    """(tap, input, first lane, valid lanes) of packed k-step entries."""
    e = entries.long()
    return e & 31, (e >> 5) & 1, e >> 13, (e >> 6) & 127


@functools.lru_cache(maxsize=None)
def _kstep_table_on(taps: int, widths: tuple, device: torch.device) -> torch.Tensor:
    return kstep_table(taps, widths).to(device)


def _tile_nonzero(wt, taps: int, c8: int, bn: int) -> torch.Tensor:
    """(N / bn, taps * ceil(c8 / 64)) bool: whether the (bn x 64) tile of
    the K-major weight wt (N, taps * c8) at each (column tile, k-step)
    holds a nonzero; lanes past c8 count as zeros."""
    k = -(-c8 // _BK) * _BK
    w = F.pad(wt.reshape(wt.shape[0], taps, c8), (0, k - c8))
    return (w != 0).reshape(wt.shape[0] // bn, bn, taps * k // _BK, _BK).any(3).any(1)


@functools.lru_cache(maxsize=None)
def dense_bn(c8: int, c8o: int) -> int:
    """The dense kernel's column tile for a (C8, C8o) weight: of 256, 128
    and 64 dividing C8o, the one that executes the fewest k-step tiles x
    BN on the block-diagonal `s2d.dil2_dense_weight` of these widths, which
    the model passes (ties: the larger). Taken from the shapes alone, so
    the wrapper needs no sync; any other weight runs at this BN too."""
    diag = torch.block_diag(*[torch.ones(c8o // 8, c8 // 8)] * 8)  # K-major, one tap
    work = {bn: bn * int(_tile_nonzero(diag, 1, c8, bn).sum())
            for bn in (256, 128, 64) if c8o % bn == 0}
    return min(work, key=lambda bn: (work[bn], -bn))


def dense_ksteps(wt, c8: int, bn: int):
    """The dense kernel's k-step lists for the K-major weight wt (C8o, 27
    C8), on its device, with no host sync: (steps (C8o / bn, nsteps) int32,
    count (C8o / bn,) int32). Column tile ct walks its first count[ct]
    entries: the k-steps whose (bn x 64) weight tile holds a nonzero, in
    ascending K order (a stable sort puts them first)."""
    nz = _tile_nonzero(wt, 27, c8, bn)
    order = torch.argsort((~nz).to(torch.uint8), dim=1, stable=True)
    return _kstep_table_on(27, (c8,), wt.device)[order].contiguous(), nz.sum(1, dtype=torch.int32)


def block_sparse_ksteps_plain(x, wd, bg):
    """The bf16 dense kernel's rule in f32: column tile ct of BN =
    `dense_bn` columns sums, over the k-steps of its list only (tap t,
    lanes [l0, l0 + valid) of x), x shifted by tap t with zero fill times
    those rows of wd; then the bias, the sums, y rounded once. A skipped
    tile holds only zeros of wd, so for finite x this is
    `dil2_dense_conv_stats_plain`; a NaN or Inf of x in a skipped lane
    would reach y there and not here."""
    b, n, c8, c8o = x.shape[0], x.shape[1], x.shape[-1], wd.shape[-1]
    bn = dense_bn(c8, c8o)
    wt = wd.float().permute(4, 0, 1, 2, 3).reshape(c8o, 27 * c8)
    steps, count = dense_ksteps(wt, c8, bn)
    tap, _, lane0, valid = kstep_fields(steps)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    y = torch.zeros((b, n, n, n, c8o), device=x.device)
    for ct in range(c8o // bn):
        cols = slice(ct * bn, (ct + 1) * bn)
        for i in range(int(count[ct])):
            t, l0, v = int(tap[ct, i]), int(lane0[ct, i]), int(valid[ct, i])
            xs = xp[:, t // 9:t // 9 + n, t // 3 % 3:t // 3 % 3 + n, t % 3:t % 3 + n, l0:l0 + v]
            y[..., cols] += xs @ wt[cols, t * c8 + l0:t * c8 + l0 + v].T
    return _with_sums(y + bg.float(), x.dtype)


# ------------------------------------------------- the dil-2 brick kernel

_BRICK_X = 8  # the bf16 dil-2 kernel's brick x extent: a slab of 8 voxels x 8 sub-positions
_SMEM_BLOCK = 232448  # 227 KB: the shared memory one block may use
# bricks (ty, tz) in the order the tile chooser tries them
_DIL2_BRICKS = ((4, 2), (2, 2), (2, 1), (1, 1))


def _dil2_kp(ci: int) -> int:
    """K of the bf16 dil-2 kernel's weight: 27 Ci rounded up to 64."""
    return -(-27 * ci // _BK) * _BK


def dil2_smem(ci: int, ty: int, tz: int, bn: int) -> int:
    """Dynamic shared memory of one block of the bf16 dil-2 kernel, in
    bytes (`layout` in csrc/dil2_wgmma.cu): the weight's column tile (Kp x
    bn bf16), the (tz+2) x (ty+2) x 10 halo brick of 8 Ci lanes a voxel,
    8 voxels of zeros where Ci / 8 is odd, the k16 steps' table and 1 KB
    of alignment slack."""
    q = ci // 8
    vox = 128 * q
    return (_dil2_kp(ci) * bn * 2 + (_BRICK_X + 2) * (ty + 2) * (tz + 2) * vox
            + (8 * vox if q % 2 else 0) + 16 * ((27 * q + 1) // 2) + 1024)


@functools.lru_cache(maxsize=None)
def dil2_tile(ci: int, co: int):
    """The bf16 dil-2 kernel's tile for widths (Ci, Co), from the shapes
    alone: (ty, tz, bn, smem): bricks of 8 x ty x tz output voxels and
    column tiles of bn channels. bn is the largest of 64, 32, 16, 8 that
    divides Co and fits; the brick the first of `_DIL2_BRICKS` that fits
    (on the card 8 x 4 x 2 ran fastest at ec3 and ec5, and at ec6 the
    largest that fits beside the BN-64 weight beat it at BN 32; PERF.md
    §6). Raises where none fits (Ci above 112)."""
    if ci % 8 or co % 8 or ci <= 0 or co <= 0:
        raise ValueError(f"Ci and Co must be positive multiples of 8, got Ci={ci}, Co={co}")
    for bn in (b for b in (64, 32, 16, 8) if co % b == 0):
        for ty, tz in _DIL2_BRICKS:
            smem = dil2_smem(ci, ty, tz, bn)
            if smem <= _SMEM_BLOCK:
                return ty, tz, bn, smem
    raise ValueError(f"the bf16 dil-2 kernel's weight and brick do not fit in shared memory "
                     f"at Ci={ci}, Co={co}")


def dil2_brick_plain(x, w, b, tile=None):
    """The bf16 dil-2 kernel's rule in f32: the output grid in bricks of
    8 x ty x tz voxels (x, y, z; the last ones ragged), each block a brick
    and `bn` columns (`tile` = (ty, tz, bn), default `dil2_tile`); its
    input the zero-filled (tz+2) x (ty+2) x 10 halo brick; per tap (dz, dy,
    dx) the brick's voxels at that offset times the shared weight w[dz, dy,
    dx] (Ci, Co), for all 8 sub-positions alike; then the bias, the sums
    over the voxels inside the volume only, y rounded once. The same
    function as `dil2_conv_stats_plain`."""
    bsz, n, ci, co = x.shape[0], x.shape[1], w.shape[3], w.shape[4]
    ty, tz, bn = tile or dil2_tile(ci, co)[:3]
    tx = _BRICK_X
    mz, my, mx = (-(-n // t) * t for t in (tz, ty, tx))
    xp = F.pad(x.float(), (0, 0, 1, mx + 1 - n, 1, my + 1 - n, 1, mz + 1 - n))
    halo = xp.unfold(1, tz + 2, tz).unfold(2, ty + 2, ty).unfold(3, tx + 2, tx)
    halo = halo.unflatten(4, (8, ci))  # (B, nbz, nby, nbx, 8, Ci, tz+2, ty+2, 10)
    wf, bf = w.float(), b.float()
    y = torch.zeros((*halo.shape[:4], tz, ty, tx, 8, co), device=x.device)
    for c0 in range(0, co, bn):
        acc = torch.zeros((*halo.shape[:4], tz, ty, tx, 8, bn), device=x.device)
        for tap in range(27):
            dz, dy, dx = tap // 9, tap // 3 % 3, tap % 3
            rows = halo[..., dz:dz + tz, dy:dy + ty, dx:dx + tx]  # (B, nb^3, 8, Ci, tz, ty, tx)
            acc += torch.einsum("bzyxpcijk,co->bzyxijkpo", rows, wf[dz, dy, dx, :, c0:c0 + bn])
        y[..., c0:c0 + bn] = acc + bf[c0:c0 + bn]
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7, 8).reshape(bsz, mz, my, mx, 8 * co)[:, :n, :n, :n]
    return _with_sums(y, x.dtype)


# ------------------------------------------------------------- wrappers


def _check_x(t, dtype, device, b, n, name):
    if t.dim() != 5 or t.shape[:4] != (b, n, n, n) or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name} must be a {dtype} (B, n, n, n, C) tensor on {device} with "
                         f"B={b}, n={n}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    vec = 16 // t.element_size()
    if t.shape[-1] % vec:
        raise ValueError(f"{name}'s lanes must be a multiple of {vec}, got {t.shape[-1]}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t


def _outputs(x, b, n, c8):
    y = torch.empty((b, n, n, n, c8), dtype=x.dtype, device=x.device)
    s1 = torch.zeros((b, c8), dtype=F32, device=x.device)
    s2 = torch.zeros((b, c8), dtype=F32, device=x.device)
    return y, s1, s2


def _check_weight(w, dtype, device, shape, name):
    if w.dtype != dtype or w.device != device or w.shape != shape:
        raise ValueError(f"{name} must be a {dtype} {shape} tensor on {device}, got "
                         f"{w.dtype} {tuple(w.shape)} on {w.device}")
    w = w.contiguous()
    if w.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return w


def _check_dtype(dt):
    if dt not in _DTYPE_CODE:
        raise TypeError(f"the conv kernels take float32 or bfloat16, got {dt}")


def _check_bias(b, c8, dev, name):
    b = b.to(device=dev, dtype=F32).contiguous()
    if b.shape != (c8,):
        raise ValueError(f"{name} must have shape ({c8},), got {tuple(b.shape)}")
    return b


def _largest_bn(ncols: int) -> int:
    """The wgmma kernel's default column tile: the largest of 256, 128, 64
    that divides the output width."""
    return next(bn for bn in (256, 128, 64) if ncols % bn == 0)


def _launch_wgmma(name, xs, wt, steps, count, bias, y, sums, n, bn):
    """One launch of the wgmma kernel's form `name`: xs one or two inputs,
    wt the K-major weight, steps the k-step list of every column tile (1-D:
    one list for all), count its length per column tile (None: all)."""
    x1 = xs[1] if len(xs) == 2 else None
    s1, s2 = (None, None) if sums is None else (sums[0].data_ptr(), sums[1].data_ptr())
    launch("airseg_conv_wgmma", name, _WGMMA_FORM[name], xs[0].data_ptr(), xs[0].shape[-1],
           None if x1 is None else x1.data_ptr(), 0 if x1 is None else x1.shape[-1],
           wt.data_ptr(), steps.data_ptr(), steps.shape[-1] if steps.dim() == 2 else 0,
           None if count is None else count.data_ptr(), steps.shape[-1], bias.data_ptr(),
           y.data_ptr(), s1, s2, y.shape[0], n, y.shape[-1], bn, _stream(y))


def _phased_conv_stats_fwd(xs, w_all, b_all):
    if not _on_card(xs[0]):
        return phased_conv_stats_plain(xs, w_all, b_all)
    dt = xs[0].dtype
    _check_dtype(dt)
    if len(xs) > 2:
        raise ValueError(f"the phased kernel reads one or two inputs, got {len(xs)}")
    b, n, dev = xs[0].shape[0], xs[0].shape[1], xs[0].device
    xs = [_check_x(t, dt, dev, b, n, f"xs[{i}]") for i, t in enumerate(xs)]
    cin, c8 = sum(t.shape[-1] for t in xs), w_all.shape[-1]
    if c8 % 64:
        raise ValueError(f"8Co must be a multiple of 64, got {c8}")
    bf16 = dt == torch.bfloat16
    if bf16 and (any(t.shape[-1] % 64 for t in xs) or (c8 > 256 and c8 % 256) or c8 == 192):
        raise ValueError("the bf16 kernel takes inputs of a multiple of 64 lanes each and "
                         f"8Co of 64, 128 or a multiple of 256, got {[t.shape[-1] for t in xs]} "
                         f"and {c8}")
    w_all = _check_weight(w_all, dt, dev, (8, cin, c8), "w_all")
    b_all = _check_bias(b_all, c8, dev, "b_all")
    y, s1, s2 = _outputs(xs[0], b, n, c8)
    with torch.cuda.device(dev):
        if bf16:  # wgmma reads the weight K-major: (8Co, 8 Cin)
            wt = w_all.permute(2, 0, 1).reshape(c8, 8 * cin).contiguous()
            steps = _kstep_table_on(8, tuple(t.shape[-1] for t in xs), dev)
            _launch_wgmma("phased_conv_stats", xs, wt, steps, None, b_all, y, (s1, s2), n,
                          _largest_bn(c8))
        else:
            x1 = xs[1] if len(xs) == 2 else None
            launch("airseg_phased_conv_stats", "phased_conv_stats", _DTYPE_CODE[dt],
                   xs[0].data_ptr(), xs[0].shape[-1], None if x1 is None else x1.data_ptr(),
                   0 if x1 is None else x1.shape[-1], w_all.data_ptr(), b_all.data_ptr(),
                   y.data_ptr(), s1.data_ptr(), s2.data_ptr(), b, n, c8 // 8, _stream(y))
    return y, s1, s2


def _dil2_conv_stats_fwd(x, w, b):
    if not _on_card(x):
        return dil2_conv_stats_plain(x, w, b)
    dt = x.dtype
    _check_dtype(dt)
    bsz, n, dev = x.shape[0], x.shape[1], x.device
    x = _check_x(x, dt, dev, bsz, n, "x")
    ci, co = x.shape[-1] // 8, w.shape[-1]
    vec = 16 // x.element_size()
    if x.shape[-1] % 8 or ci % vec or co % 8:
        raise ValueError(f"Ci must be a multiple of {vec} and Co of 8, got Ci={ci}, Co={co}")
    w = _check_weight(w, dt, dev, (3, 3, 3, ci, co), "w")
    b = _check_bias(b, co, dev, "b")
    y, s1, s2 = _outputs(x, bsz, n, 8 * co)
    with torch.cuda.device(dev):
        if dt == torch.bfloat16:  # the halo-brick wgmma kernel, weight K-major (Co, Kp)
            ty, tz, bn, _ = dil2_tile(ci, co)
            kp = _dil2_kp(ci)
            wt = F.pad(w.reshape(27 * ci, co).t(), (0, kp - 27 * ci)).contiguous()
            launch("airseg_dil2_wgmma", "dil2_conv_stats", x.data_ptr(), ci, wt.data_ptr(), kp,
                   b.data_ptr(), y.data_ptr(), s1.data_ptr(), s2.data_ptr(), bsz, n, co, ty, tz,
                   bn, _stream(y))
        else:
            launch("airseg_dil2_conv_stats", "dil2_conv_stats", _DTYPE_CODE[dt], x.data_ptr(),
                   ci, w.data_ptr(), b.data_ptr(), y.data_ptr(), s1.data_ptr(), s2.data_ptr(),
                   bsz, n, co, _stream(y))
    return y, s1, s2


def _dil2_dense_conv_stats_fwd(x, wd, bg):
    if not _on_card(x):
        return dil2_dense_conv_stats_plain(x, wd, bg)
    dt = x.dtype
    _check_dtype(dt)
    bsz, n, dev = x.shape[0], x.shape[1], x.device
    x = _check_x(x, dt, dev, bsz, n, "x")
    c8, c8o = x.shape[-1], wd.shape[-1]
    if c8o % 64:
        raise ValueError(f"C8o must be a multiple of 64, got {c8o}")
    wd = _check_weight(wd, dt, dev, (3, 3, 3, c8, c8o), "wd")
    bg = _check_bias(bg, c8o, dev, "bg")
    y, s1, s2 = _outputs(x, bsz, n, c8o)
    with torch.cuda.device(dev):
        if dt == torch.bfloat16:  # wgmma, K-major (C8o, 27 C8), all-zero weight tiles skipped
            bn = dense_bn(c8, c8o)
            wt = wd.permute(4, 0, 1, 2, 3).reshape(c8o, 27 * c8).contiguous()
            steps, count = dense_ksteps(wt, c8, bn)
            dense_tiles.update(bn=bn, nsteps=steps.shape[1], count=count)
            _launch_wgmma("dil2_dense_conv_stats", [x], wt, steps, count, bg, y, (s1, s2), n, bn)
        else:
            launch("airseg_dil2_dense_conv_stats", "dil2_dense_conv_stats", _DTYPE_CODE[dt],
                   x.data_ptr(), c8, wd.data_ptr(), bg.data_ptr(), y.data_ptr(), s1.data_ptr(),
                   s2.data_ptr(), bsz, n, c8o, _stream(y))
    return y, s1, s2


def _phased_conv_ungathered_fwd(xs, w_all, b_all):
    if not _on_card(xs[0]):
        return phased_conv_ungathered_plain(xs, w_all, b_all)
    dt = xs[0].dtype
    _check_dtype(dt)
    if len(xs) > 2:
        raise ValueError(f"the phased kernel reads one or two inputs, got {len(xs)}")
    b, n, dev = xs[0].shape[0], xs[0].shape[1], xs[0].device
    xs = [_check_x(t, dt, dev, b, n, f"xs[{i}]") for i, t in enumerate(xs)]
    cin, c8o = sum(t.shape[-1] for t in xs), w_all.shape[-1]
    if c8o % 64:
        raise ValueError(f"8Co must be a multiple of 64, got {c8o}")
    w_all = _check_weight(w_all, dt, dev, (2, 2, 2, cin, c8o), "w_all")
    b_all = _check_bias(b_all, c8o, dev, "b_all")
    m = n + 1
    y = torch.empty((b, m, m, m, c8o), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        if dt == torch.bfloat16:  # wgmma reads the weight K-major: (8Co, 8 Cin)
            wt = w_all.permute(4, 0, 1, 2, 3).reshape(c8o, 8 * cin).contiguous()
            steps = _kstep_table_on(8, tuple(t.shape[-1] for t in xs), dev)
            _launch_wgmma("phased_conv_ungathered", xs, wt, steps, None, b_all, y, None, n,
                          _largest_bn(c8o))
        else:
            x1 = xs[1] if len(xs) == 2 else None
            launch("airseg_phased_conv_ext", "phased_conv_ungathered", _DTYPE_CODE[dt],
                   xs[0].data_ptr(), xs[0].shape[-1], None if x1 is None else x1.data_ptr(),
                   0 if x1 is None else x1.shape[-1], w_all.data_ptr(), b_all.data_ptr(),
                   y.data_ptr(), b, n, c8o, _stream(y))
    return y


# ---------------------------------------------------------- autograd


def _plain_vjp(plain, inputs, cts, needs):
    """Gradients of `plain(*inputs)` against the cotangents `cts`, for the
    inputs flagged in `needs`; None elsewhere."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
        outs = plain(*leaves)
    wanted = [t for t, need in zip(leaves, needs) if need]
    grads = iter(torch.autograd.grad(outs, wanted, cts) if wanted else ())
    return [next(grads) if need else None for need in needs]


class _KernelVjp(torch.autograd.Function):
    """A conv wrapper under autograd: `fwd(*inputs)` forward, saving the
    inputs only; backward = autograd of `plain(*inputs)`."""

    @staticmethod
    def forward(ctx, fwd, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return fwd(*inputs)

    @staticmethod
    def backward(ctx, *cts):
        return (None, None, *_plain_vjp(ctx.plain, ctx.saved_tensors, cts,
                                        ctx.needs_input_grad[2:]))


def _call(fwd, plain, *inputs):
    """fwd(*inputs), through `_KernelVjp` when a gradient is wanted."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _KernelVjp.apply(fwd, plain, *inputs)
    return fwd(*inputs)


def phased_conv_stats(xs, w_all, b_all):
    """Phased s2d conv + statistics: xs (B, n, n, n, Cin), or a list of
    two forming a plain concat of Cin lanes; w_all (8, Cin, 8Co), taps
    s = sz*4 + sy*2 + sx (the 2^3 kernel of `s2d.phased_conv_weights`
    flattened); b_all (8Co,). Returns y (B, n, n, n, 8Co) in x's dtype,
    s1, s2 (B, 8Co) f32. Replaces phased_conv_stats."""
    xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
    return _call(lambda w, b, *x: _phased_conv_stats_fwd(list(x), w, b),
                 lambda w, b, *x: phased_conv_stats_plain(list(x), w, b), w_all, b_all, *xs)


def dil2_conv_stats(x, w, b):
    """Dilation-2 s2d conv + statistics: x (B, n, n, n, 8Ci), w the
    reference (3, 3, 3, Ci, Co) kernel, b (Co,). Returns y (B, n, n, n,
    8Co) in x's dtype, s1, s2 (B, 8Co) f32. Replaces dil2_conv_stats. The
    bf16 kernel takes Ci and Co multiples of 8 and Ci up to 112
    (`dil2_tile`); it raises on other widths."""
    return _call(_dil2_conv_stats_fwd, dil2_conv_stats_plain, x, w, b)


def dil2_dense_conv_stats(x, wd, bg):
    """Dense pad-1 3^3 conv of an s2d tensor + statistics: x (B, n, n, n,
    C8), wd (3, 3, 3, C8, C8o) in x's dtype, bg (C8o,). Returns y (B, n,
    n, n, C8o) in x's dtype, s1, s2 (B, C8o) f32. Replaces
    dil2_conv_stats_bm. In bf16 the kernel skips the k-steps whose weight
    tile is all zeros (`block_sparse_ksteps_plain`): the same result for
    finite x, but a NaN or Inf of x in a skipped lane, which the dense TPU
    kernel would carry into y as NaN, does not reach y here."""
    return _call(_dil2_dense_conv_stats_fwd, dil2_dense_conv_stats_plain, x, wd, bg)


def phased_conv_ungathered(xs, w_all, b_all=None):
    """The phased conv's ungathered output: xs (B, n, n, n, Cin), or a
    list of two forming a plain concat; w_all (2, 2, 2, Cin, 8Co) in x's
    dtype; b_all (8Co,) or None (no bias). Returns y_ext (B, n+1, n+1,
    n+1, 8Co) in x's dtype, accumulated in f32 and rounded once. Replaces
    phased_conv_ext_bm and _pconv_kgrid_forward."""
    xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
    if b_all is None:
        b_all = torch.zeros(w_all.shape[-1], dtype=F32, device=w_all.device)
    return _call(lambda w, b, *x: _phased_conv_ungathered_fwd(list(x), w, b),
                 lambda w, b, *x: phased_conv_ungathered_plain(list(x), w, b),
                 w_all, b_all, *xs)
