"""Fused epilogue of the s2d conv blocks: InstanceNorm affine, then
LeakyReLU(0.01), then 0, 1 or 2 spatial SE gates, in one pass; and its
backward.

Counterpart of the JAX package's `ops/pallas_s2d.py`. Its Pallas entry
points on the inference and train paths are three CUDA kernels here
(`csrc/epilogue.cu`, built and bound by `ops/cuda_lib.py`):

  * `gathered_epilogue`: over an already-gathered s2d conv output
    (B, nz, n, n, 8C) (gated_norm_finalize[_bm]);
  * `phased_epilogue`: over the phased conv's UNGATHERED output
    (B, nz+1, n+1, xw, 8C); sub-position q = (a, b, c) of voxel
    (z, y, x) reads y_ext[z+a, y+b, x+c] in lane block q
    (phased_finalize[_bm]);
  * `phased_normalize`: the phased form without LeakyReLU and gates,
    the normalized pre-activation that the phased backward reads
    (phased_normalize).

The depth extent nz is n for a cube and n / n_space for a depth slab of
the mesh's `space` axis. Each kernel is persistent: the gathered form
reads with 16-byte loads, the phased forms with TMA or, where a tensor map
cannot describe y_ext or its box rows are short, 16-byte loads. The
wrappers take the design from the tensor's shape and strides before the
launch (`pick_design`), and the tile walk and TMA boxes are stated in
plain Python beside it (`epilogue_tiles_plain`, `phased_tma_gather_plain`,
`thread_rows_plain`) for the CPU tests. Each wrapper takes its plain PyTorch version
(`*_plain`) for a CPU tensor only; on a CUDA tensor it launches the
kernel or raises. Each counts its launches in `cuda_lib.launch_counts`.

The block functions take the InstanceNorm statistics from a fourth
kernel, K12 (`norm_stats`, csrc/norm_stats.cu): per (sample, lane) the
f32 sum and sum of squares of the conv output, one read in its own dtype,
over a gathered tensor or, in place, over the 8 phase windows of the
phased conv's ungathered output. The 8 sub-positions then fold per
original channel and the affine follows in torch (var = E[y^2] - mean^2
clamped at 0, scale = rsqrt(var+eps), shift = mean*scale, e = y*scale -
shift), handed to the epilogue kernels. Its row partition and window
walk are stated in plain Python beside it (`norm_stats_reads_plain`,
`norm_stats_chunk`); on a CPU tensor it takes `norm_stats_plain` (f32
sums, f64 for f64 inputs). The backward's sums Q and R stay in plain
torch. Under a profiler session the statistics run in the span
`norm.stats`, Q and R in `norm.bwd_stats` (see `utils.profiling`):

  * `gated_norm_block(y, wse)`: gathered form (dense-lift, grouped
    dil-2 and CATConv blocks);
  * `phased_gated_block(xs, w_all, b_all, wse)`: phased conv (cuDNN,
    list partial sums; with `ext_kernel`, the `phased_conv_ungathered`
    kernel), 8-phase-window statistics, phased form
    (`_phased_gated_forward_bm`, pallas_s2d.py:1280);
  * `dil2_gated_block(x, wd, bg, wse)`: the dense dil-2 conv with its
    sums (`dil2_dense_conv_stats`), the affine from those sums, gathered
    form (`_dil2_gated_forward_bm`, pallas_s2d.py:2263).

With `space=` (a `parallel.DataMesh` whose `space` axis splits the depth)
each block runs on this rank's depth slab: the statistics' sums, and in
the backward the sums Q and R, add over the space ranks
(`parallel.space_sum`), the voxel count is the whole crop's, and the
phased conv takes its depth padding from the neighbouring slabs
(`parallel.halo`), in the forward and in the backward's replay, whose
halo returns its cotangent to the neighbours.

Under autograd each is a `torch.autograd.Function` that saves the block
inputs only. The gathered and phased blocks' backward is the JAX
package's hand-written epilogue backward (`pallas_s2d.py:2362-2547`) in
plain torch ops, recomputing the statistics (and, for the phased block,
the conv); the dil-2 block's is the same core backward after a replay of
the dense conv (the XLA-composition vjp of pallas_s2d.py:2296). The gate
weights are the compact (G, C) `wse`, so the backward returns their
gradient directly. Without autograd (inference) the blocks call the
forward alone.
"""

from __future__ import annotations

import functools
from itertools import product

import numpy as np
import torch

from ..parallel.mesh import space_sum
from ..utils.profiling import span
from .conv import conv3d
from .conv_stats import dil2_dense_conv_stats, phased_conv_ungathered
from .cuda_lib import _DTYPE_CODE, F32, _acc, _on_card, _stream, launch
from .norms import leaky_relu
from .s2d import _affine8, phase_windows, phased_conv_ext


# ----------------------------------------------------------- plain versions


def gathered_epilogue_plain(y, scale8, shift8, wse=None):
    """Plain PyTorch version of the gathered epilogue, with the kernel's
    rounding points. y (B, n, n, n, 8C); scale8/shift8 (B, 8C) f32;
    wse (G, C) in y's dtype or None."""
    dt, acc = y.dtype, _acc(y.dtype)
    bshape = (y.shape[0], 1, 1, 1, y.shape[-1])
    e = y.to(acc) * scale8.reshape(bshape) - shift8.reshape(bshape)
    e = torch.where(e >= 0, e, 0.01 * e).to(dt)
    if wse is not None:
        c = y.shape[-1] // 8
        for g in range(wse.shape[0]):
            ep = e.unflatten(-1, (8, c))
            logit = (ep.to(acc) * wse[g].to(acc)).sum(-1)
            gate = torch.sigmoid(logit).to(dt)
            e = (ep * gate.unsqueeze(-1)).flatten(-2)
    return e


def phased_epilogue_plain(y_ext, scale8, shift8, wse=None):
    """Plain PyTorch version of the phased epilogue: gather the 8 phase
    windows of y_ext (B, nz+1, n+1, xw, 8C), then the gathered epilogue."""
    y = torch.cat(phase_windows(y_ext), dim=-1)
    return gathered_epilogue_plain(y, scale8, shift8, wse)


def phased_normalize_plain(y_ext, scale8, shift8):
    """Plain PyTorch version of phased_normalize: the 8 phase windows of
    y_ext, gathered, times scale8 minus shift8, rounded once to y_ext's
    dtype."""
    y = torch.cat(phase_windows(y_ext), dim=-1)
    bshape = (y.shape[0], 1, 1, 1, y.shape[-1])
    a = y.to(_acc(y.dtype)) * scale8.reshape(bshape) - shift8.reshape(bshape)
    return a.to(y.dtype)


# ----------------------------------------------------------- tile walk

TILE_BYTES = 16384


def epilogue_tile(c8: int, elt: int, phased: bool) -> int:
    """T, the voxels of one tile of the persistent kernels: about
    TILE_BYTES of 8C-lane rows, 16 to 64 voxels along x (phased) or 16 to
    128 rows (gathered); `tile_voxels` in csrc/epilogue.cu."""
    return max(16, min(TILE_BYTES // (c8 * elt), 64 if phased else 128))


def epilogue_tiles_plain(b: int, nz: int, n: int, tile: int, phased: bool):
    """The persistent kernels' tile walk (`tile_at` in csrc/epilogue.cu)
    over a (b, nz, n, n) output (nz = n: a cube): for each tile index t in
    order, (b, z, y, x0, count). A phased tile is `count` output voxels
    (z, y, x0..x0+count-1); a gathered tile is rows x0..x0+count-1 of
    batch entry b (z = y = 0). Block k of a grid of G takes tiles k, k+G,
    k+2G, ..."""
    if phased:
        tiles_x = -(-n // tile)
        for t in range(b * nz * n * tiles_x):
            xt, r = t % tiles_x, t // tiles_x
            yy, r = r % n, r // n
            z, bb = r % nz, r // nz
            yield bb, z, yy, xt * tile, min(tile, n - xt * tile)
    else:
        n3 = nz * n * n
        tiles_x = -(-n3 // tile)
        for t in range(b * tiles_x):
            x0 = (t % tiles_x) * tile
            yield t // tiles_x, 0, 0, x0, min(tile, n3 - x0)


def _box(y, starts, sizes):
    """TMA's box read: y[starts : starts + sizes] per dimension, zeros
    outside y (the tensor map's out-of-bounds fill)."""
    out = torch.zeros(sizes, dtype=y.dtype)
    src = tuple(slice(st, min(st + sz, dim)) for st, sz, dim in zip(starts, sizes, y.shape))
    got = y[src]
    out[tuple(slice(0, g) for g in got.shape)] = got
    return out


def phased_tma_gather_plain(y_ext, tile: int):
    """The TMA design's phase gather, tile by tile: per tile the 4 boxes
    (T+1 voxels x 2C lanes) at y_ext[b, z+a, y+b', x0 : x0+T+1,
    (4a+2b')C : (4a+2b'+2)C], sub-position (a, b', c) of voxel i read from
    box (a, b') at voxel i + c, lanes cC : (c+1)C, of y_ext (B, nz+1,
    n+1, xw, 8C). Returns the gathered (B, nz, n, n, 8C) and how often
    each output voxel was written."""
    b, nz, n, c8 = y_ext.shape[0], y_ext.shape[1] - 1, y_ext.shape[2] - 1, y_ext.shape[-1]
    c = c8 // 8
    out = torch.zeros((b, nz, n, n, c8), dtype=y_ext.dtype)
    writes = torch.zeros((b, nz, n, n), dtype=torch.int64)
    for bb, z, yy, x0, count in epilogue_tiles_plain(b, nz, n, tile, True):
        boxes = [_box(y_ext, (bb, z + q // 2, yy + q % 2, x0, 2 * q * c),
                      (1, 1, 1, tile + 1, 2 * c)).reshape(tile + 1, 2 * c) for q in range(4)]
        rows = torch.cat([boxes[p // 2][p % 2:p % 2 + count, (p % 2) * c:(p % 2 + 1) * c]
                          for p in range(8)], dim=-1)
        out[bb, z, yy, x0:x0 + count] = rows
        writes[bb, z, yy, x0:x0 + count] += 1
    return out, writes


def thread_rows_plain(c8: int, elt: int, tile: int, rows_in_flight: int = 4):
    """The rows of a tile each thread of a 256-thread block handles, per
    pass (`i0 + s + u * pass` in csrc/epilogue.cu): a list, per thread, of
    (row, first lane) pairs; rows past the tile are skipped."""
    vec = 16 // elt
    per_row = c8 // vec
    step = 256 // per_row
    out = []
    for tid in range(256):
        s, j = tid // per_row, tid % per_row
        out.append([(i0 + s + u * step, j * vec)
                    for i0 in range(0, tile, step * rows_in_flight)
                    for u in range(rows_in_flight) if i0 + s + u * step < tile])
    return out


def _tma_strides_ok(y_ext) -> bool:
    """Whether the phased TMA tensor map can describe y_ext: each stride
    spans the dimension inside it (x >= 8C lanes, y >= xw voxels, ...)."""
    mz, my, xw, c8 = y_ext.shape[1], y_ext.shape[2], y_ext.shape[3], y_ext.shape[4]
    sb, sz, sy, sx = (y_ext.stride(i) for i in range(4))
    return sx >= c8 and sy >= xw * sx and sz >= my * sy and sb >= mz * sz


def pick_design(y, phased: bool) -> str:
    """The persistent design that reads y, from its shape and strides
    alone, before the launch: the gathered form has one, 16-byte loads;
    the phased forms (`phased_epilogue`, `phased_normalize`) take TMA
    where its boxes' rows (2C lanes) hold at least 128 bytes and a tensor
    map can describe y_ext (nested strides), else 16-byte loads."""
    if phased and y.shape[-1] // 4 * y.element_size() >= 128 and _tma_strides_ok(y):
        return "persistent tma"
    return "persistent ldg"


# ------------------------------------------------------------- wrappers


def _check_common(y, scale8, shift8, wse, c8):
    if y.dtype not in _DTYPE_CODE:
        raise TypeError(f"epilogue kernels take float32 or bfloat16, got {y.dtype}")
    b = y.shape[0]
    for name, t in (("scale8", scale8), ("shift8", shift8)):
        if t.dtype != F32 or t.shape != (b, c8) or not t.is_contiguous() \
                or t.device != y.device:
            raise ValueError(f"{name} must be a contiguous float32 ({b}, {c8}) "
                             f"tensor on {y.device}")
    vec = 16 // y.element_size()
    c = c8 // 8
    row, tpp = c8 // vec, c // vec
    if c8 % (8 * vec) or row & (row - 1) or tpp & (tpp - 1) or row > 256 or tpp > 32:
        raise ValueError(f"unsupported channel width 8C={c8} for {y.dtype}")
    if wse is not None:
        if wse.dtype != y.dtype or wse.dim() != 2 or wse.shape[1] != c \
                or not wse.is_contiguous() or wse.device != y.device:
            raise ValueError(f"wse must be a contiguous ({wse.shape[0]}, {c}) "
                             f"{y.dtype} tensor on {y.device}")
        if wse.shape[0] > 2:
            raise ValueError(f"the kernels take at most 2 SE gates, got {wse.shape[0]}")
    if y.data_ptr() % 16:
        raise ValueError("input must be 16-byte aligned")
    return vec


def gathered_epilogue(y, scale8, shift8, wse=None):
    """Gathered epilogue: y (B, nz, n, n, 8C) contiguous -> same shape
    (nz = n: a cube; a depth slab has nz < n). Replaces
    gated_norm_finalize_bm / gated_norm_finalize."""
    if not _on_card(y):
        return gathered_epilogue_plain(y, scale8, shift8, wse)
    if y.dim() != 5 or y.shape[2] != y.shape[3] or not y.is_contiguous():
        raise ValueError(f"y must be a contiguous (B, nz, n, n, 8C) tensor, got "
                         f"{tuple(y.shape)}")
    b, nz, n, c8 = y.shape[0], y.shape[1], y.shape[2], y.shape[-1]
    _check_common(y, scale8, shift8, wse, c8)
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        launch("airseg_gathered_epilogue", "gathered_epilogue",
               _DTYPE_CODE[y.dtype], y.data_ptr(), out.data_ptr(), scale8.data_ptr(),
               shift8.data_ptr(), None if wse is None else wse.data_ptr(),
               0 if wse is None else wse.shape[0], b, nz, n, c8, _stream(y))
    return out


def _check_phased(y_ext, scale8, shift8, wse):
    """Shape and stride checks of the phased kernels; returns
    (B, nz, n, 8C, (sb, sz, sy, sx), tma), tma 1 where `pick_design`
    takes TMA."""
    if y_ext.dim() != 5 or y_ext.shape[3] < y_ext.shape[2] or y_ext.stride(4) != 1:
        raise ValueError(f"y_ext must be (B, nz+1, n+1, xw>=n+1, 8C) with unit "
                         f"channel stride, got {tuple(y_ext.shape)}")
    b, mz, m, c8 = y_ext.shape[0], y_ext.shape[1], y_ext.shape[2], y_ext.shape[-1]
    vec = _check_common(y_ext, scale8, shift8, wse, c8)
    strides = tuple(y_ext.stride(i) for i in range(4))
    if any(s % vec for s in strides):
        raise ValueError("y_ext strides must be multiples of 16 bytes")
    tma = int(pick_design(y_ext, True) == "persistent tma")
    return b, mz - 1, m - 1, c8, strides, tma


def phased_epilogue(y_ext, scale8, shift8, wse=None):
    """Phased epilogue: y_ext (B, nz+1, n+1, xw, 8C), xw >= n+1, any
    16-byte-aligned strides with a unit channel stride -> gathered
    (B, nz, n, n, 8C). Replaces phased_finalize_bm / phased_finalize."""
    if not _on_card(y_ext):
        return phased_epilogue_plain(y_ext, scale8, shift8, wse)
    b, nz, n, c8, (sb, sz, sy, sx), tma = _check_phased(y_ext, scale8, shift8, wse)
    out = torch.empty((b, nz, n, n, c8), dtype=y_ext.dtype, device=y_ext.device)
    with torch.cuda.device(y_ext.device):
        launch("airseg_phased_epilogue", "phased_epilogue",
               _DTYPE_CODE[y_ext.dtype], tma, y_ext.data_ptr(), sb, sz, sy, sx,
               y_ext.shape[3], out.data_ptr(), scale8.data_ptr(),
               shift8.data_ptr(), None if wse is None else wse.data_ptr(),
               0 if wse is None else wse.shape[0], b, nz, n, c8, _stream(y_ext))
    return out


def phased_normalize(y_ext, scale8, shift8):
    """Phase gather + InstanceNorm affine only: y_ext as for
    `phased_epilogue` -> a (B, nz, n, n, 8C) = dtype(y * scale8 - shift8).
    Replaces phased_normalize."""
    if not _on_card(y_ext):
        return phased_normalize_plain(y_ext, scale8, shift8)
    b, nz, n, c8, (sb, sz, sy, sx), tma = _check_phased(y_ext, scale8, shift8, None)
    out = torch.empty((b, nz, n, n, c8), dtype=y_ext.dtype, device=y_ext.device)
    with torch.cuda.device(y_ext.device):
        launch("airseg_phased_normalize", "phased_normalize",
               _DTYPE_CODE[y_ext.dtype], tma, y_ext.data_ptr(), sb, sz, sy, sx,
               y_ext.shape[3], out.data_ptr(), scale8.data_ptr(), shift8.data_ptr(), b, nz,
               n, c8, _stream(y_ext))
    return out


# --------------------------------------------------------- statistics

NS_THREADS = 256        # threads of a K12 block (csrc/norm_stats.cu kThreads)
NS_BLOCKS_PER_SM = 4    # K12 blocks an SM holds (kBlocksPerSm)


def norm_stats_plain(y, phased: bool = False):
    """Plain PyTorch version of `norm_stats`: the per-(sample, lane) sum
    and sum of squares, (2, B, 8C) in f32 (f64 for f64 inputs), of a
    gathered y (B, nz, n, n, 8C) or, `phased`, over the 8 phase windows of
    y_ext (B, nz+1, n+1, xw, 8C), lane block q from window q."""
    acc = _acc(y.dtype)
    if not phased:
        yf = y.to(acc)
        return torch.stack([yf.sum(dim=(1, 2, 3)), torch.square(yf).sum(dim=(1, 2, 3))])
    s1, s2 = [], []
    for sl in phase_windows(y):
        slf = sl.to(acc)
        s1.append(slf.sum(dim=(1, 2, 3)))
        s2.append(torch.square(slf).sum(dim=(1, 2, 3)))
    return torch.stack([torch.cat(s1, dim=-1), torch.cat(s2, dim=-1)])


def norm_stats_chunk(b: int, rows: int, c8: int, elt: int, sms: int) -> int:
    """Rows of one K12 block: a batch entry's `rows` voxel rows
    (`norm_stats_rows`) are cut into chunks of whole passes (a pass:
    256 / (8C / V) rows, V lanes a 16-byte vector), so that the b entries'
    chunks make about NS_BLOCKS_PER_SM blocks on each of the card's `sms`
    SMs, one wave."""
    step = NS_THREADS // (c8 * elt // 16)
    passes = -(-rows // step)
    per_block = max(1, -(-b * passes // (NS_BLOCKS_PER_SM * sms)))
    return min(per_block, passes) * step


def norm_stats_rows(shape, phased: bool) -> int:
    """The voxel rows K12 walks in a y of `shape`: a gathered y's nz*n*n,
    a phased y_ext's (nz+1)(n+1)^2 grid (its x extent past n+1 is not
    read)."""
    return shape[1] * shape[2] * (shape[2] if phased else shape[3])


def norm_stats_reads_plain(shape, phased: bool, elt: int, chunk: int):
    """K12's reads of batch entry 0, as `block_sums` and `Walk` in
    csrc/norm_stats.cu make them: the element offset of every 16-byte
    vector loaded by every block (k, 0) and thread (s, j) over its passes,
    for a contiguous y (B, nz, n, n, 8C) or `phased` y_ext (B, nz+1, n+1,
    xw, 8C). Block (k, b) reads b's offsets (b * the batch stride more).
    Rows are voxels in memory order (phased: of the (nz+1, n+1, n+1) grid,
    a lane block loaded where the voxel lies in its window); the walk steps
    (z, y, x) by adding, as the kernel does."""
    if phased:
        _, mz, m, xw, c8 = shape
        nz, n, ny = mz - 1, m - 1, m
    else:
        _, nz, n, xw, c8 = shape
        m = ny = n
    sx, sy = c8, xw * c8
    sz = ny * sy
    vec = 16 // elt
    per_row = c8 // vec
    step = NS_THREADS // per_row
    rows = norm_stats_rows(shape, phased)
    chunks = -(-rows // chunk)
    k = np.repeat(np.arange(chunks), step)
    r = k * chunk + np.tile(np.arange(step), chunks)
    end = np.minimum((k + 1) * chunk, rows)
    z, rem = np.divmod(r, m * m)
    yy, x = np.divmod(rem, m)
    off = z * sz + yy * sy + x * sx
    cols = np.arange(per_row) * vec
    q = cols // (c8 // 8)
    qa, qb, qc = q >> 2 & 1, q >> 1 & 1, q & 1
    reads = []
    while (r < end).any():
        live = r < end
        if phased:
            inside = ((0 <= z[:, None] - qa) & (z[:, None] - qa < nz)
                      & (0 <= yy[:, None] - qb) & (yy[:, None] - qb < n)
                      & (0 <= x[:, None] - qc) & (x[:, None] - qc < n))
        else:
            inside = np.ones((len(r), per_row), dtype=bool)
        at = off[:, None] + cols[None, :]
        reads.append(at[live[:, None] & inside])
        r, x, off = r + step, x + step, off + step * sx
        wrap = x >= m
        while wrap.any():
            x, off = x - m * wrap, off + (sy - m * sx) * wrap
            yy = yy + wrap
            ywrap = yy == m
            yy, z, off = yy - m * ywrap, z + ywrap, off + (sz - m * sy) * ywrap
            wrap = x >= m
    return np.concatenate(reads).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def norm_stats(y, phased: bool = False):
    """Per-(sample, lane) sum and sum of squares of a block's conv output,
    (2, B, 8C) f32: K12 (csrc/norm_stats.cu), one read of y in its own
    dtype. Gathered: y (B, nz, n, n, 8C); `phased`: the ungathered y_ext
    (B, nz+1, n+1, xw >= n+1, 8C), lane block q over phase window q, read
    in place. y contiguous, float32 or bfloat16, 8C / V a power of two up
    to 256 (V = 16 bytes of lanes), and, phased, C a multiple of V. On a
    CPU tensor: `norm_stats_plain`."""
    if not _on_card(y):
        return norm_stats_plain(y, phased)
    if y.dtype not in _DTYPE_CODE:
        raise TypeError(f"norm_stats takes float32 or bfloat16, got {y.dtype}")
    if y.dim() != 5 or not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError(f"y must be a contiguous, 16-byte aligned 5-D tensor, got "
                         f"{tuple(y.shape)} with strides {y.stride()}")
    b, c8 = y.shape[0], y.shape[-1]
    if phased:
        nz, n = y.shape[1] - 1, y.shape[2] - 1
        ok = y.shape[3] >= n + 1
    else:
        nz, n = y.shape[1], y.shape[2]
        ok = y.shape[3] == n
    vec = 16 // y.element_size()
    row = c8 // vec
    if not ok or nz < 1 or n < 1:
        raise ValueError(f"unsupported {'phased' if phased else 'gathered'} shape "
                         f"{tuple(y.shape)}")
    if c8 % vec or row & (row - 1) or row > NS_THREADS or (phased and (c8 // 8) % vec):
        raise ValueError(f"unsupported channel width 8C={c8} for {y.dtype}")
    rows = norm_stats_rows(y.shape, phased)
    chunk = norm_stats_chunk(b, rows, c8, y.element_size(), _sm_count(y.device.index))
    part = torch.empty((b, -(-rows // chunk), 2, c8), dtype=F32, device=y.device)
    sums = torch.empty((2, b, c8), dtype=F32, device=y.device)
    code = _DTYPE_CODE[y.dtype]
    with torch.cuda.device(y.device):
        if phased:
            launch("airseg_norm_stats_phased", "norm_stats", code, y.data_ptr(),
                   *(y.stride(i) for i in range(4)), part.data_ptr(), sums.data_ptr(),
                   b, nz, n, c8, chunk, _stream(y))
        else:
            launch("airseg_norm_stats_gathered", "norm_stats", code, y.data_ptr(),
                   part.data_ptr(), sums.data_ptr(), b, nz, n, c8, chunk, _stream(y))
    return sums


def _whole_affine(s12, nvox: int, eps: float, space):
    """`_affine8` of the (2, B, 8C) per-lane sums s12 over `nvox` values:
    the 8 sub-positions add per original channel; with `space`, of this
    rank's depth slab: the sums add over the space ranks (one collective)
    and the count is the whole crop's."""
    b, c8 = s12.shape[1], s12.shape[2]
    s12 = s12.reshape(2, b, 8, c8 // 8).sum(2)
    if space is not None:
        s12 = space_sum(s12, space)
        nvox *= space.space_size
    return _affine8(s12[0], s12[1], nvox, eps)


def _gathered_affine(y, eps: float, space=None):
    """InstanceNorm affine of a gathered s2d tensor (per original channel,
    over space x 8 sub-positions)."""
    with span("norm.stats"):
        return _whole_affine(norm_stats(y.contiguous()),
                             y.shape[1] * y.shape[2] * y.shape[3] * 8, eps, space)


def _phased_affine(y_ext, eps: float, space=None):
    """InstanceNorm affine over the 8 phase windows of a phased conv's
    ungathered output (B, nz+1, n+1, n+1, 8C)."""
    with span("norm.stats"):
        nz, n = y_ext.shape[1] - 1, y_ext.shape[2] - 1
        return _whole_affine(norm_stats(y_ext, phased=True), 8 * nz * n * n, eps, space)


# ---------------------------------------------------------- backwards


def _gate_chain_bwd(e0, wse, ct):
    """Backward of the SE gate chain e_{g+1} = e_g * sigmoid(<e_g, w_g>)
    (per sub-position of an s2d tensor), given the pre-gate tensor e0
    (..., 8C). Returns (d_e0, d_wse) with d_wse (G, C), or None without
    gates. Port of `_gate_chain_bwd` (pallas_s2d.py:2362) on the compact
    gate vectors: the one-hot re-expansion is a constant and has no
    cotangent."""
    dt = e0.dtype
    if wse is None:
        return ct.to(dt), None
    c = wse.shape[1]
    w = wse.to(dt)
    es, gates = [e0], []
    for g in range(wse.shape[0]):
        e8 = es[-1].unflatten(-1, (8, c))
        gate = torch.sigmoid(e8 @ w[g])
        gates.append(gate)
        if g < wse.shape[0] - 1:
            es.append((e8 * gate.unsqueeze(-1)).flatten(-2))
    d = ct.to(dt)
    dws = [None] * len(gates)
    for g in reversed(range(len(gates))):
        e8, gate = es[g].unflatten(-1, (8, c)), gates[g]
        d8 = d.unflatten(-1, (8, c))
        dlog = (d8 * e8).sum(-1) * gate * (1 - gate)
        dws[g] = (e8.reshape(-1, c).transpose(0, 1) @ dlog.reshape(-1))
        d = (d8 * gate.unsqueeze(-1) + dlog.unsqueeze(-1) * w[g]).flatten(-2)
    return d, torch.stack(dws)


def _core_bwd_from_a(a, scale8, wse, ct, nvox: int, space=None):
    """Backward of e = gates(LeakyReLU(a)) and of the InstanceNorm that
    made a = y*scale - shift, given a: gate chain backward, then the
    IN + LeakyReLU backward with both statistics sums, Q = sum(da) and
    R = sum(da * a) per original channel (`_core_bwd_from_a`,
    pallas_s2d.py:2409). The LeakyReLU mask is taken on the rounded a.
    `space`: a is this rank's depth slab of a crop of `nvox` values; Q and
    R add over the space ranks (the cotangents of the whole crop's
    statistics)."""
    acc = _acc(a.dtype)
    b, c8 = a.shape[0], a.shape[-1]
    c = c8 // 8
    d_e0, d_wse = _gate_chain_bwd(leaky_relu(a), wse, ct)
    af = a.to(acc)
    d = d_e0.to(acc)
    daf = torch.where(a >= 0, d, d * 0.01)
    del d, d_e0
    with span("norm.bwd_stats"):
        qr = torch.stack([daf.sum(dim=(1, 2, 3)), (daf * af).sum(dim=(1, 2, 3))])
        if space is not None:
            qr = space_sum(qr, space)
        q = qr[0].reshape(b, 8, c).sum(1).repeat(1, 8)
        r = qr[1].reshape(b, 8, c).sum(1).repeat(1, 8)
    bshape = (b, 1, 1, 1, c8)
    dy = scale8.reshape(bshape) * (daf - (q.reshape(bshape) + af * r.reshape(bshape)) / nvox)
    return dy.to(a.dtype), d_wse


def _gated_core_bwd(y, wse, ct, eps: float = 1e-5, space=None):
    """Backward of the gathered block e = gates(LeakyReLU(IN(y))): the
    statistics and the normalized a recomputed from y, then
    `_core_bwd_from_a` (`_gated_core_bwd`, pallas_s2d.py:2437).
    Returns (dy, d_wse)."""
    scale8, shift8 = _gathered_affine(y, eps, space)
    bshape = (y.shape[0], 1, 1, 1, y.shape[-1])
    a = (y.to(scale8.dtype) * scale8.reshape(bshape) - shift8.reshape(bshape)).to(y.dtype)
    n_space = 1 if space is None else space.space_size
    return _core_bwd_from_a(a, scale8, wse, ct,
                            8 * y.shape[1] * y.shape[2] * y.shape[3] * n_space, space)


def _manual_phased_gated_bwd(xs, w_all, b_all, wse, ct, eps: float = 1e-5,
                             needs=None, space=None):
    """Backward of the phased block (`_manual_phased_gated_bwd`,
    pallas_s2d.py:2467): replay the phased conv under autograd, recompute
    the window statistics, take the normalized a from `phased_normalize`,
    run the core backward in the gathered layout, scatter the cotangent
    back to the conv's (nz+1, n+1, n+1) output and take the conv's
    backward. With `space` the replay takes its halo again, and the
    halo's backward sends the boundary planes' cotangent to the
    neighbouring slabs.

    `needs`: which of (xs..., w_all, b_all) want a gradient (default
    all). Returns (dxs, dw_all, db_all, d_wse); None where not wanted."""
    xs = list(xs)
    nz, n = xs[0].shape[1], xs[0].shape[2]
    co = w_all.shape[-1] // 8
    inputs = [*xs, w_all, b_all]
    needs = needs if needs is not None else [t is not None for t in inputs]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(inputs, needs)]
        y = phased_conv_ext(leaves[:-2], leaves[-2], leaves[-1], space)
    yd = y.detach().contiguous()
    scale8, shift8 = _phased_affine(yd, eps, space)
    a = phased_normalize(yd, scale8, shift8)
    n_space = 1 if space is None else space.space_size
    dyg, d_wse = _core_bwd_from_a(a, scale8, wse, ct, 8 * nz * n * n * n_space, space)
    del a, yd
    dy_ext = torch.zeros_like(y)
    for q, (az, bb, cc) in enumerate(product(range(2), repeat=3)):
        dy_ext[:, az:az + nz, bb:bb + n, cc:cc + n, q * co:(q + 1) * co] = \
            dyg[..., q * co:(q + 1) * co]
    del dyg
    wanted = [t for t, need in zip(leaves, needs) if need]
    grads = iter(torch.autograd.grad(y, wanted, dy_ext) if wanted else ())
    out = [next(grads) if need else None for need in needs]
    return out[:-2], out[-2], out[-1], d_wse


# ------------------------------------------------------------ block functions


def _gated_norm_forward(y, wse, eps, space=None):
    y = y.contiguous()
    scale8, shift8 = _gathered_affine(y, eps, space)
    return gathered_epilogue(y, scale8, shift8, wse)


def _phased_forward(xs, w_all, b_all, wse, eps, ext_kernel=False, space=None):
    if ext_kernel:
        if space is not None:
            raise NotImplementedError("the ungathered conv kernel takes no depth slab "
                                      "(ROADMAP M9b)")
        y = phased_conv_ungathered(xs, w_all, b_all)
    else:
        y = phased_conv_ext(xs, w_all, b_all, space)
    y = y.contiguous()
    scale8, shift8 = _phased_affine(y, eps, space)
    return phased_epilogue(y, scale8, shift8, wse)


def _dil2_forward(x, wd, bg, wse, eps):
    y, s1, s2 = dil2_dense_conv_stats(x, wd, bg)
    with span("norm.stats"):
        b, c = y.shape[0], y.shape[-1] // 8
        nvox = 8 * y.shape[1] * y.shape[2] * y.shape[3]
        scale8, shift8 = _affine8(s1.reshape(b, 8, c).sum(1), s2.reshape(b, 8, c).sum(1),
                                  nvox, eps)
    return gathered_epilogue(y, scale8, shift8, wse)


class _GatedNormBlock(torch.autograd.Function):
    """gated_norm_block under autograd: saves y (and wse); backward =
    `_gated_core_bwd` (the custom vjp of pallas_s2d.py:852-872)."""

    @staticmethod
    def forward(ctx, y, wse, eps, space):
        ctx.eps, ctx.space = eps, space
        ctx.save_for_backward(y, wse)
        return _gated_norm_forward(y, wse, eps, space)

    @staticmethod
    def backward(ctx, ct):
        y, wse = ctx.saved_tensors
        dy, d_wse = _gated_core_bwd(y, wse, ct, ctx.eps, ctx.space)
        return (dy if ctx.needs_input_grad[0] else None,
                d_wse if ctx.needs_input_grad[1] else None, None, None)


class _PhasedGatedBlock(torch.autograd.Function):
    """phased_gated_block under autograd: saves the block inputs only
    (xs, w_all, b_all, wse); backward = `_manual_phased_gated_bwd` (the
    custom vjp of pallas_s2d.py:1031-1054)."""

    @staticmethod
    def forward(ctx, w_all, b_all, wse, eps, ext_kernel, space, *xs):
        ctx.eps, ctx.space = eps, space
        ctx.save_for_backward(w_all, b_all, wse, *xs)
        return _phased_forward(list(xs), w_all, b_all, wse, eps, ext_kernel, space)

    @staticmethod
    def backward(ctx, ct):
        w_all, b_all, wse, *xs = ctx.saved_tensors
        ng = ctx.needs_input_grad
        dxs, dw, db, d_wse = _manual_phased_gated_bwd(
            xs, w_all, b_all, wse, ct, ctx.eps, needs=[*ng[6:], ng[0], ng[1]],
            space=ctx.space)
        return (dw, db, d_wse if ng[2] else None, None, None, None, *dxs)


class _Dil2GatedBlock(torch.autograd.Function):
    """dil2_gated_block under autograd: saves the block inputs only
    (x, wd, bg, wse); backward = the dense conv replayed under autograd,
    `_gated_core_bwd` on its output, then the conv's backward."""

    @staticmethod
    def forward(ctx, x, wd, bg, wse, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, wd, bg, wse)
        return _dil2_forward(x, wd, bg, wse, eps)

    @staticmethod
    def backward(ctx, ct):
        x, wd, bg, wse = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip((x, wd, bg), needs)]
            y = conv3d(*leaves, padding=1)
        dy, d_wse = _gated_core_bwd(y.detach(), wse, ct, ctx.eps)
        wanted = [t for t, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(y, wanted, dy) if wanted else ())
        return (*[next(grads) if need else None for need in needs],
                d_wse if ctx.needs_input_grad[3] else None, None)


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def gated_norm_block(y, wse=None, eps: float = 1e-5, space=None):
    """InstanceNorm (per original channel, over space x 8 sub-positions)
    + LeakyReLU + SE gate(s) of a gathered s2d conv output; with `space`
    (a `parallel.DataMesh`), of this rank's depth slab of it."""
    if _wants_grad(y, wse):
        return _GatedNormBlock.apply(y, wse, eps, space)
    return _gated_norm_forward(y, wse, eps, space)


def phased_gated_block(xs, w_all, b_all, wse=None, eps: float = 1e-5,
                       ext_kernel: bool = False, space=None):
    """Phased s2d conv block: conv of the plain concat `xs` with the
    phase-stacked kernel (list partial sums, padding 1; with `ext_kernel`
    the `phased_conv_ungathered` kernel, accumulated in f32 and rounded
    once), statistics over the 8 phase windows of the ungathered output,
    then the phased epilogue; with `space` (a `parallel.DataMesh`), on
    this rank's depth slabs."""
    xs = list(xs)
    if _wants_grad(*xs, w_all, b_all, wse):
        return _PhasedGatedBlock.apply(w_all, b_all, wse, eps, ext_kernel, space, *xs)
    return _phased_forward(xs, w_all, b_all, wse, eps, ext_kernel, space)


def dil2_gated_block(x, wd, bg, wse=None, eps: float = 1e-5):
    """Dilation-2 s2d conv block as one dense conv with its sums: x (B, n,
    n, n, C8), wd the block-diagonal (3, 3, 3, C8, C8o)
    `s2d.dil2_dense_weight`, bg (C8o,); InstanceNorm per original channel
    from the kernel's sums (var clamped at 0), then the gathered
    epilogue."""
    if _wants_grad(x, wd, bg, wse):
        return _Dil2GatedBlock.apply(x, wd, bg, wse, eps)
    return _dil2_forward(x, wd, bg, wse, eps)
