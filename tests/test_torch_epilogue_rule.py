"""The index rules of the persistent epilogue kernels (K1/K2/K5,
csrc/epilogue.cu) and of the instance_norm_leaky kernels (K7,
csrc/norm_leaky.cu), on the CPU, numpy and torch only.

The persistent kernels walk tiles of T voxels (`epilogue_tiles_plain`);
the TMA design reads each phased tile as 4 boxes of (T+1 voxels x 2C
lanes). Gathering through those boxes must give the plain version's gather
(`torch.cat(phase_windows(y_ext))`) exactly and write every output
voxel once, and every (row, 16-byte vector) of a tile must belong to one
thread. Each holds on a depth slab of the mesh's `space` axis too
(nz < n: y_ext (B, nz+1, n+1, xw, 8C), output (B, nz, n, n, 8C)). K7's
partition of (B, S, C) into 16-byte vectors (or single channels where C
or a base does not allow them), shared by the forward and the backward,
must read every element once. Catches an off-by-one in a
box or a tail before any card run."""

import numpy as np
import pytest
import torch

from se_unet_airseg_tpu_torch.ops import epilogue_s2d as eps
from se_unet_airseg_tpu_torch.ops import norm_leaky
from se_unet_airseg_tpu_torch.ops.s2d import phase_windows

# the model's phased calls (8C, gates) at n = 32 / 64, scaled to n = 8 / 9
PHASED_CALLS = [(256, 2), (512, 2), (256, 2), (256, 1), (128, 1)]


def _y_ext(b, n, c8, xw, seed, nz=None):
    rng = np.random.default_rng(seed)
    nz = n if nz is None else nz
    return torch.from_numpy(rng.standard_normal((b, nz + 1, n + 1, xw, c8)).astype(np.float32))


@pytest.mark.parametrize("slab", [False, True])
@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("c8", [64, 128, 256, 512])
@pytest.mark.parametrize("n,pad", [(8, 0), (9, 3)])
def test_phased_tma_boxes_reproduce_the_phase_gather(c8, elt, n, pad, slab):
    """xw = n+1+pad: the padded x extent of a batch-major conv output; at
    n = 9 no T divides n. `slab`: a depth slab of nz = 3 planes (the
    (nz+1)-plane window grid of a halo'd phased conv)."""
    nz = 3 if slab else n
    y_ext = _y_ext(2, n, c8, n + 1 + pad, c8 + n, nz)
    tile = eps.epilogue_tile(c8, elt, True)
    got, writes = eps.phased_tma_gather_plain(y_ext, tile)
    want = torch.cat(phase_windows(y_ext), dim=-1)
    assert got.shape == (2, nz, n, n, c8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool((writes == 1).all())


@pytest.mark.parametrize("nz", [9, 1, 4])
@pytest.mark.parametrize("tile", [2, 4, 5])
def test_phased_tma_boxes_with_several_tiles_per_row(tile, nz):
    """T below n: several tiles per x row, the last one ragged; the box of
    the last tile reaches past xw and reads the tensor map's zero fill; on
    a cube (nz = n) and on slabs."""
    n = 9
    y_ext = _y_ext(1, n, 128, n + 1, tile, nz)
    got, writes = eps.phased_tma_gather_plain(y_ext, tile)
    torch.testing.assert_close(got, torch.cat(phase_windows(y_ext), dim=-1), rtol=0,
                               atol=0)
    assert bool((writes == 1).all())


def test_tiles_at_the_model_shapes():
    """T per call shape: about 16 KB of rows; a phased tile never spans
    more than one x row, a gathered tile never two batch entries."""
    assert [eps.epilogue_tile(c8, 2, True) for c8, _ in PHASED_CALLS] == [32, 16, 32, 32, 64]
    assert [eps.epilogue_tile(c8, 2, False) for c8 in (64, 128, 256, 512)] == [128, 64, 32, 16]
    for n, nz, phased in ((9, 9, True), (9, 9, False), (32, 32, True), (32, 16, True),
                          (64, 32, False), (9, 2, True), (9, 3, False)):
        tile = eps.epilogue_tile(256, 2, phased)
        tiles = list(eps.epilogue_tiles_plain(2, nz, n, tile, phased))
        extent = n if phased else nz * n * n
        assert all(0 < count <= tile and x0 + count <= extent for _, _, _, x0, count in tiles)
        assert sum(count for *_, count in tiles) == 2 * nz * n * n
        if phased:  # every (b, z, y) row once, z over the slab's nz planes
            rows = {(b, z, y) for b, z, y, _, _ in tiles}
            assert rows == {(b, z, y) for b in range(2) for z in range(nz) for y in range(n)}


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("c8", [64, 128, 256, 512])
@pytest.mark.parametrize("phased", [True, False])
def test_every_row_and_lane_of_a_tile_is_one_threads(c8, elt, phased):
    """Within a tile each (row, 16-byte vector) belongs to one thread, and
    a thread keeps one lane column for the whole kernel."""
    tile = eps.epilogue_tile(c8, elt, phased)
    vec = 16 // elt
    owners = np.zeros((tile, c8 // vec), dtype=np.int64)
    for rows in eps.thread_rows_plain(c8, elt, tile):
        assert len({lane for _, lane in rows}) <= 1
        for row, lane in rows:
            owners[row, lane // vec] += 1
    assert bool((owners == 1).all())


def test_design_is_chosen_by_shape():
    """The phased forms take TMA where its box rows (2C lanes) hold at
    least 128 bytes and the strides nest; a view whose z stride is below
    its y stride and the bf16 8C = 128 form take 16-byte loads, the same
    for `phased_epilogue` and `phased_normalize`; the gathered form has
    one design, 16-byte loads, at every width. The plain version of the
    swapped view is still the phase gather."""
    n = 5
    y_ext = _y_ext(1, n, 128, n + 3, 1)
    assert eps.pick_design(y_ext, True) == "persistent tma"
    assert eps.pick_design(y_ext[:, :, :, :n + 1], True) == "persistent tma"
    assert eps.pick_design(y_ext.to(torch.bfloat16), True) == "persistent ldg"
    assert eps.pick_design(_y_ext(1, n, 256, n + 1, 2).to(torch.bfloat16), True) == \
        "persistent tma"
    gathered = y_ext[:, :n, :n, :n].contiguous()
    for c8 in (64, 128, 256, 512):
        for dtype in (torch.float32, torch.bfloat16):
            g = gathered[..., :1].expand(-1, -1, -1, -1, c8).contiguous().to(dtype)
            assert eps.pick_design(g, False) == "persistent ldg"
    swapped = y_ext.transpose(1, 2)
    assert eps.pick_design(swapped, True) == "persistent ldg"
    scale8, shift8 = torch.ones(1, 128), torch.zeros(1, 128)
    got = eps.phased_normalize(swapped, scale8, shift8)
    torch.testing.assert_close(got, torch.cat(phase_windows(swapped), dim=-1), rtol=0, atol=0)
    # depth slabs (nz + 1 < n + 1 planes): the strides still nest, TMA applies
    slab = _y_ext(2, n, 128, n + 3, 3, nz=2)
    assert eps.pick_design(slab, True) == "persistent tma"
    assert eps.pick_design(slab[:, :, :, :n + 1], True) == "persistent tma"
    assert eps.pick_design(slab.transpose(1, 2)[:, :3], True) == "persistent ldg"
    assert eps.pick_design(slab[:, :2, :n, :n].contiguous(), False) == "persistent ldg"


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("b,s,c", [(1, 7, 3), (2, 100, 40), (1, 64, 256), (2, 300, 32),
                                   (1, 40, 8), (1, 9, 4096)])
def test_norm_bwd_partition_reads_every_element_once(b, s, c, elt, aligned, bwd):
    """K7's partition, shared by the forward and the backward, at C = 3, 8,
    32, 40, 256 and a C wider than one block row, vectorized and on the
    scalar path (C % V != 0 or a misaligned base): every element read once
    per pass; and each direction's form at that shape (the ring, 16-byte
    register loads, or one channel per thread)."""
    v, ring, grid, parts = norm_leaky.partition_plain(b, s, c, elt, aligned, blocks=264)
    assert v == (16 // elt if aligned and c % (16 // elt) == 0 else 1)
    assert ring == (v * elt == 16 and c // v <= 256)
    assert norm_leaky.uses_ring(c, elt, aligned) == ring
    want = (f"16-byte vectors, bulk-copy ring of {6 if not bwd else 3} stages, two passes"
            if ring else f"{v}-channel register loads, two passes")
    assert norm_leaky.design(c, elt, aligned, bwd) == want
    seen = np.zeros((b, s, c), dtype=np.int64)
    for (block, _), elems in parts.items():
        for bb, row, ch in elems:
            assert bb == block[2]
            seen[bb, row, ch:ch + v] += 1
    assert bool((seen == 1).all())
    assert grid[0] * grid[1] * grid[2] <= max(264, b * grid[1])


def test_norm_bwd_division_is_ieee_for_every_bf16_value():
    """The kernels' y / 0.01 (a reciprocal product corrected once by an
    FMA) equals the IEEE float32 quotient for every negative finite bf16
    y, the values the bf16 kernel divides."""
    ys = (np.arange(1 << 15, 1 << 16, dtype=np.uint32) << 16).view(np.float32)
    ys = ys[np.isfinite(ys)]
    with np.errstate(over="ignore"):
        want = ys / np.float32(norm_leaky.SLOPE)
    np.testing.assert_array_equal(norm_leaky.div_slope_plain(ys), want)


def test_norm_bwd_vector_width():
    assert [norm_leaky.vector_width(c, 2, True) for c in (3, 8, 12, 32, 40, 256)] == \
        [1, 8, 1, 8, 8, 8]
    assert [norm_leaky.vector_width(c, 4, True) for c in (3, 8, 12, 40)] == [1, 4, 4, 4]
    assert norm_leaky.vector_width(256, 2, False) == 1
