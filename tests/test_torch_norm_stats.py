"""The InstanceNorm statistics of the s2d blocks (K12, csrc/norm_stats.cu)
on the CPU, port only, torch and numpy:

  * `norm_stats_plain`, in both forms, against the sums the block
    functions computed before the kernel (an f32 or f64 copy, its square,
    two reductions; the phased form window by window), on cubes, depth
    slabs (nz < n) and C = 8, 16 and 64;
  * the kernel's partition of the rows over blocks and threads, its row
    walk and the phased form's window masks (`norm_stats_reads_plain`,
    `norm_stats_chunk`, `norm_stats_rows`): every 16-byte vector of a
    gathered y, or of the 8 phase windows of y_ext, read exactly once and
    nothing else read, at each of the 15 blocks' shapes of a 128^3 tile
    batch at batch 8 and on the depth slabs of the mesh's `space` axis;
  * the wrapper taking the plain version on a CPU tensor.
"""

import numpy as np
import pytest
import torch

from se_unet_airseg_tpu_torch.ops import epilogue_s2d as eps
from se_unet_airseg_tpu_torch.ops import launch_counts, reset_launch_counts
from se_unet_airseg_tpu_torch.ops.s2d import phase_windows

H100_SMS = 132
# (block, form, s2d grid n, 8C) of every statistics call of a tile batch of
# 128^3 tiles: the 10 gathered blocks and the 5 phased ones
CALLS = [("ec1", False, 64, 64), ("ec2", False, 64, 128), ("ec3", False, 64, 256),
         ("ec33", False, 64, 256), ("x33", False, 64, 256), ("ec5", False, 32, 256),
         ("ec6", False, 32, 512), ("ec63", False, 32, 512), ("x63", False, 32, 512),
         ("dc42", False, 32, 256), ("ec4", True, 32, 256), ("dc3", True, 32, 512),
         ("dc4", True, 32, 256), ("dc5", True, 64, 256), ("dc6", True, 64, 128)]


def _old_gathered_sums(y):
    """The gathered block's sums before K12 (`_gathered_affine`)."""
    yf = y.to(torch.float64 if y.dtype == torch.float64 else torch.float32)
    return yf.sum(dim=(1, 2, 3)), torch.square(yf).sum(dim=(1, 2, 3))


def _old_phased_sums(y_ext):
    """The phased block's (B, C) sums before K12 (`_phased_affine`): window
    by window, each added to the running sums."""
    acc = torch.float64 if y_ext.dtype == torch.float64 else torch.float32
    s1 = s2 = 0.0
    for sl in phase_windows(y_ext):
        slf = sl.to(acc)
        s1 = s1 + slf.sum(dim=(1, 2, 3))
        s2 = s2 + torch.square(slf).sum(dim=(1, 2, 3))
    return s1, s2


SHAPES = [(2, 4, 4, 64), (1, 3, 5, 128), (3, 2, 6, 512), (2, 1, 7, 64)]  # (b, nz, n, 8C)
TOL = {torch.float32: dict(rtol=2e-6, atol=1e-5), torch.float64: dict(rtol=1e-12, atol=1e-12)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,nz,n,c8", SHAPES)
def test_gathered_plain_matches_the_old_sums(b, nz, n, c8, dtype):
    """C = 8, 16 and 64; nz < n: a depth slab. The same reductions as
    before, so the same numbers."""
    y = torch.randn((b, nz, n, n, c8), generator=torch.Generator().manual_seed(c8 + n),
                    dtype=dtype)
    got = eps.norm_stats_plain(y)
    assert got.shape == (2, b, c8) and got.dtype == dtype
    for g, w in zip(got, _old_gathered_sums(y)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("xpad", [0, 3])
@pytest.mark.parametrize("b,nz,n,c8", SHAPES)
def test_phased_plain_matches_the_old_sums(b, nz, n, c8, xpad, dtype):
    """Lane block q over phase window q, folded over the 8 sub-positions:
    the old window-by-window (B, C) sums, in another order of the 8 adds.
    xpad: y_ext's x extent past n+1."""
    y = torch.randn((b, nz + 1, n + 1, n + 1 + xpad, c8),
                    generator=torch.Generator().manual_seed(c8 + nz), dtype=dtype)
    got = eps.norm_stats_plain(y, phased=True)
    assert got.shape == (2, b, c8) and got.dtype == dtype
    folded = got.reshape(2, b, 8, c8 // 8).sum(2)
    for g, w in zip(folded, _old_phased_sums(y)):
        torch.testing.assert_close(g, w, **TOL[dtype])
    for q, sl in enumerate(phase_windows(y)):  # lane block q is window q's, alone
        torch.testing.assert_close(got[0][:, q * (c8 // 8):(q + 1) * (c8 // 8)],
                                   sl.sum(dim=(1, 2, 3)), rtol=0, atol=0)


def _window_vectors(shape, vec):
    """Element offsets of the 16-byte vectors of the 8 phase windows of a
    contiguous y_ext of `shape`, batch entry 0 (from `phase_windows`)."""
    idx = torch.arange(int(np.prod(shape[1:])), dtype=torch.int64).reshape(shape[1:])[None]
    return torch.cat([w.reshape(-1, w.shape[-1])[:, ::vec].reshape(-1)
                      for w in phase_windows(idx)]).numpy()


def _check_reads(shape, phased, elt, sms=H100_SMS):
    b, c8 = shape[0], shape[-1]
    nz, n = (shape[1] - 1, shape[2] - 1) if phased else (shape[1], shape[2])
    vec = 16 // elt
    chunk = eps.norm_stats_chunk(b, eps.norm_stats_rows(shape, phased), c8, elt, sms)
    step = eps.NS_THREADS // (c8 // vec)
    assert chunk % step == 0  # whole passes a block
    got = np.sort(eps.norm_stats_reads_plain(shape, phased, elt, chunk))
    want = np.sort(_window_vectors(shape, vec)) if phased else \
        np.arange(0, nz * n * n * c8, vec)
    assert got.shape == want.shape and np.array_equal(got, want)  # each vector once
    return chunk


@pytest.mark.parametrize("block,phased,n,c8", CALLS, ids=[c[0] for c in CALLS])
def test_every_vector_is_read_once_at_the_model_shapes(block, phased, n, c8):
    """Batch 8, bf16, 128^3 tiles: every 16-byte vector of batch entry 0
    read once (block (k, b) reads entry b at the same offsets), and the
    chunks make about one wave of NS_BLOCKS_PER_SM blocks an SM."""
    m = n + 1 if phased else n
    chunk = _check_reads((8, m, m, m, c8), phased, 2)
    blocks = 8 * -(-m ** 3 // chunk)
    assert eps.NS_BLOCKS_PER_SM * H100_SMS <= blocks <= eps.NS_BLOCKS_PER_SM * H100_SMS + 8


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("phased", [False, True])
@pytest.mark.parametrize("b,nz,n,c8,xw", [(8, 32, 64, 256, None), (8, 16, 32, 512, None),
                                          (3, 2, 5, 64, 9), (1, 1, 9, 128, None),
                                          (1, 4, 4, 64, None), (2, 3, 33, 256, 40)])
def test_every_vector_is_read_once_on_slabs_and_ragged_shapes(b, nz, n, c8, xw, phased, elt):
    """Depth slabs of the mesh's `space` axis (dc5 and dc3 of 128^3 crops
    on 2 ranks), a ragged grid, a pass of more rows than n (the walk
    wraps several times), y_ext's x extent past n+1; bf16 and f32."""
    shape = (b, nz + 1, n + 1, xw or n + 1, c8) if phased else (b, nz, n, n, c8)
    _check_reads(shape, phased, elt)


@pytest.mark.parametrize("sms", [1, 7, 132])
def test_chunks_cover_each_entry_and_fill_the_card(sms):
    """Chunks are whole passes, cover a batch entry's rows, and make at
    most one wave of NS_BLOCKS_PER_SM blocks an SM (plus one ragged chunk
    an entry) and at least half of one where the rows allow it (a block
    takes whole passes, rounded up)."""
    for b, rows, c8, elt in [(8, 32 ** 3, 256, 2), (1, 32 ** 3, 256, 2), (8, 64 ** 3, 64, 4),
                             (2, 7, 512, 2), (1, 1, 64, 2)]:
        chunk = eps.norm_stats_chunk(b, rows, c8, elt, sms)
        step = eps.NS_THREADS // (c8 * elt // 16)
        assert chunk % step == 0 and chunk >= step
        chunks = -(-rows // chunk)
        assert (chunks - 1) * chunk < rows <= chunks * chunk
        passes = -(-rows // step)
        wave = eps.NS_BLOCKS_PER_SM * sms
        assert 2 * b * chunks >= min(wave, b * passes)
        assert b * chunks <= max(wave, b) + b


def test_wrapper_takes_the_plain_version_on_cpu():
    """On a CPU tensor `norm_stats` is `norm_stats_plain` (any float
    dtype, no width rule) and launches nothing."""
    g = torch.Generator().manual_seed(3)
    reset_launch_counts()
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        y = torch.randn((2, 3, 4, 4, 24), generator=g).to(dtype)
        torch.testing.assert_close(eps.norm_stats(y), eps.norm_stats_plain(y), rtol=0, atol=0)
        y_ext = torch.randn((2, 4, 5, 6, 24), generator=g).to(dtype)
        torch.testing.assert_close(eps.norm_stats(y_ext, phased=True),
                                   eps.norm_stats_plain(y_ext, phased=True), rtol=0, atol=0)
    assert launch_counts["norm_stats"] == 0 and not any(launch_counts.values())


@pytest.mark.parametrize("phased", [False, True])
def test_affine_from_the_new_sums_matches_the_old_affine(phased):
    """The block functions' InstanceNorm affine (`_gathered_affine`,
    `_phased_affine`) from K12's plain version against the one from the
    old sums, in float64 and on a depth slab's shapes."""
    g = torch.Generator().manual_seed(5)
    b, nz, n, c8 = 2, 3, 6, 128
    if phased:
        y = torch.randn((b, nz + 1, n + 1, n + 1, c8), generator=g, dtype=torch.float64)
        s1, s2 = _old_phased_sums(y)
        got = eps._phased_affine(y, 1e-5)
    else:
        y = torch.randn((b, nz, n, n, c8), generator=g, dtype=torch.float64)
        s1, s2 = (s.reshape(b, 8, c8 // 8).sum(1) for s in _old_gathered_sums(y))
        got = eps._gathered_affine(y, 1e-5)
    want = eps._affine8(s1, s2, 8 * nz * n * n, 1e-5)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-12, atol=1e-12)
