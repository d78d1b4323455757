"""Whole-volume sliding-window inference on the GPU.

The volume is uploaded once. Per batch of tiles, the tile gather, the
HU dual windowing, the forward, the
sigmoid and the overlap accumulation all run on the device; the only
download is the result. The result can be the float32 averaged score
volume or a "trit" field (0 = below the low threshold, 1 = hysteresis
band, 2 = seed), packed base-3 at 5 voxels a byte and split into a
per-block min/max summary plus payload chunks, so that the host copies
only the blocks that are not constant.

Two routes, equal in value:
  * s2d-folded: the volume is folded to (D/2, H/2, (W/2)*8) once, tiles
    are gathered straight into the model's s2d entry layout, the s2d
    heads accumulate without a per-batch unfold, and the sum unfolds
    once per volume. Needs even extents and even tile positions;
  * per-tile: full-resolution tiles in and out (odd extents).

The forward is the s2d fast path (`models.se_unet.apply_fast`), or with
`fast=False` the reference-layout `models.se_unet.apply` on the per-tile
route. A `SwinUNETRConfig` runs Swin UNETR (`models.swin_unetr.apply`) on
the per-tile route, its one logit map through the same sigmoid, overlap
average and trits; the model is chosen once, at construction. In train
mode (`train_mode=True`, as the validation and test drivers run it)
DropLayer draws its uniforms per tile batch, from a `torch.Generator` or
from `drop_draws`, one `[r_en, r_de]` per batch.

Under a mesh (`parallel.make_mesh`; JAX `sliding_window.py:165-193,
277-282`) every data row runs its batch/n_data tiles of each tile batch
on the per-tile route, and with n_space > 1 every space rank of the row
its depth slab of them (`apply_fast(..., space=mesh)`); the slabs are
gathered over space, then the tiles' scores over data in tile order, and
every rank accumulates all of them in the same order: the volume is
returned on every rank. In train mode each rank draws the batch's global
uniforms and uses its rows of them.

The overlap average divides by the number of tiles over each voxel. That
count is a function of the tile grid alone, a Cartesian product of per-axis
starts plus repeats of the first position, so it is built on the device
for every volume as the outer product of three 1-D counts
(`inv_overlap_count`), with no host volume and no upload.

Under a profiler session (`utils.profiling`) a volume's host work is the
span `runner.volume` with `runner.prep` (pad, cast and upload of the
volume), one `runner.tile_batch` per tile batch and `runner.inv_count`
(the count's launches) under it; `fetch_trits` is `runner.fetch` (the
summary's copy waits for the device) with `runner.decode` (the mixed
chunks' copies and the base-3 unpack) under it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..data.tiling import pad_positions_to_batch, tile_positions
from ..models import swin_unetr
from ..models.se_unet import (
    SEUNetConfig,
    apply as se_unet_apply,
    apply_fast,
    draw_dropout,
    prepare_fast_params,
)
from ..ops import hu_dual_window
from ..parallel.mesh import all_gather_rows, all_gather_slabs, check_mesh
from ..utils.devices import resolve_device
from ..utils.profiling import span


def _pad_to_cube(vol: np.ndarray, cube: int, fill: float):
    """Pad only volumes smaller than one cube; tile positions clamp the
    border windows inward into real data (reference tiling)."""
    shape = np.asarray(vol.shape)
    target = np.maximum(shape, cube)
    pads = [(0, int(t - s)) for s, t in zip(shape, target)]
    if all(p == (0, 0) for p in pads):
        return vol, shape
    return np.pad(vol, pads, constant_values=fill), shape


def unpack_trits(packed: np.ndarray, n_voxels: int, shape) -> np.ndarray:
    """Inverse of the base-3 5-voxel/byte packing."""
    b = packed.reshape(-1).astype(np.uint8)
    out = np.empty(b.size * 5, np.uint8)
    for k in range(5):
        out[k::5] = b % 3
        if k < 4:
            b = b // 3
    return out[:n_voxels].reshape(shape)


# --- block-constant trit codec ---------------------------------------
# The trit field is mostly block-constant (background all-0, saturated
# interior all-2): a per-block min/max summary byte says which blocks are
# mixed, and only payload chunks holding a mixed block are copied.
VOX_PER_BLOCK = 10240  # divisible by 5 -> 2048 payload bytes per block
BLOCKS_PER_CHUNK = 16  # 32 KiB per fetchable payload chunk


def decode_trit_summary(summary: np.ndarray, fetch_chunk, n_voxels: int,
                        shape) -> np.ndarray:
    """Rebuild the trit volume from a block summary; `fetch_chunk(i)`
    returns payload chunk i as uint8 and is called only for chunks that
    contain a mixed block."""
    s = np.asarray(summary, np.uint8)
    mn, mx = s >> 2, s & 3
    out = np.empty((s.size, VOX_PER_BLOCK), np.uint8)
    const = mn == mx
    out[const] = mn[const, None]
    mixed = np.flatnonzero(~const)
    bpb = VOX_PER_BLOCK // 5
    for c in np.unique(mixed // BLOCKS_PER_CHUNK):
        data = np.asarray(fetch_chunk(int(c)), np.uint8).reshape(-1, bpb)
        sel = mixed[(mixed // BLOCKS_PER_CHUNK) == c]
        local = sel - int(c) * BLOCKS_PER_CHUNK
        out[sel] = unpack_trits(data[local], len(sel) * VOX_PER_BLOCK,
                                (len(sel), VOX_PER_BLOCK))
    return out.reshape(-1)[:n_voxels].reshape(shape)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def make_chunk_fetcher(summary_np: np.ndarray, chunks, payload=None,
                       frac: float = 0.25):
    """The `fetch_chunk` callback for `decode_trit_summary`: one copy of
    the whole payload when more than `frac` of the chunks hold a mixed
    block (each copy pays a fixed latency), else one copy per needed
    chunk."""
    if payload is not None and len(chunks):
        s = np.asarray(summary_np, np.uint8)
        mixed = np.flatnonzero((s >> 2) != (s & 3))
        n_need = len(np.unique(mixed // BLOCKS_PER_CHUNK))
        if n_need > frac * len(chunks):
            p = _host(payload).reshape(len(chunks), -1)
            return lambda i: p[i]
    return lambda i: _host(chunks[i])


def trits_to_scores(trits: np.ndarray, h_thresh: float, l_thresh: float) -> np.ndarray:
    """A score volume with the same double-threshold behaviour: seeds ->
    h, band -> l, rest -> 0."""
    lut = np.array([0.0, l_thresh, h_thresh], np.float32)
    return lut[trits]


def inv_overlap_count(padded_shape, pos: np.ndarray, cube: int, device) -> torch.Tensor:
    """float32 1 / max(count, 1) on `device`, where count is the number of
    `cube`-sided tiles at `pos` over each voxel of the padded volume.

    `pos` is `data.tiling`'s grid: the Cartesian product of per-axis
    starts, then repeats of its first position. The count is the outer
    product of the three axes' counts plus the repeats over the first
    cube; small integers, exact in float32, so the reciprocal equals the
    per-tile sum's bit for bit."""
    pos = np.asarray(pos)
    starts = [np.unique(pos[:, a]) for a in range(3)]
    n_grid = math.prod(len(s) for s in starts)
    n_rep = int((pos == pos[0]).all(axis=1).sum()) - 1
    if len(np.unique(pos, axis=0)) != n_grid or n_grid + n_rep != len(pos):
        raise ValueError(f"{len(pos)} tile positions are not a grid of {n_grid} plus "
                         f"{n_rep} repeats of the first")
    axes = []
    for extent, axis_starts in zip(padded_shape, starts):
        a = torch.zeros(extent, dtype=torch.float32, device=device)
        for s in axis_starts.tolist():
            a[s : s + cube] += 1.0
        axes.append(a)
    cnt = (axes[0][:, None] * axes[1])[:, :, None] * axes[2]
    if n_rep:
        x, y, z = pos[0].tolist()
        cnt[x : x + cube, y : y + cube, z : z + cube] += n_rep
    return cnt.clamp_min_(1.0).reciprocal_()


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class SlidingWindowRunner:
    """Tile-batch engine; one instance per (params, config). `params` is
    a parameter tree or an `SEUNet`. Runs on `device` (default `cuda`;
    raises without CUDA unless `device="cpu"`).

    `train_mode`: DropLayer on, as the reference's validation and test run
    the net; the predict methods then need `generator=` or `drop_draws=`.
    `fast=False` runs the reference-layout `apply` on the per-tile route.
    `mesh` (a `parallel.DataMesh`) splits every tile batch over its data
    rows and each tile's depth over its space ranks: `batch` must be a
    multiple of n_data, `cube` of 8 x n_space, and the default device is
    the rank's.

    The runner holds no volume between calls: each volume's overlap count
    is built anew on the device (`inv_overlap_count`), every rank of a mesh
    the same.

    With a `models.swin_unetr.SwinUNETRConfig` the runner runs Swin UNETR
    (`params` its MONAI-named state dict) on the per-tile route; that
    model draws nothing in train mode, so `train_mode` is eval mode for it,
    and a mesh may split its tile batches over data rows only."""

    def __init__(self, params, cfg: SEUNetConfig = SEUNetConfig(), *,
                 cube: int = 128, step: int = 64, batch: int = 1,
                 head: str = "decoder", use_sigmoid: bool = True,
                 train_mode: bool = False, fast: bool = True, mesh=None, device=None):
        check_mesh(mesh)
        if mesh is not None and batch % mesh.data_size:
            raise ValueError(f"batch {batch} must be a multiple of the mesh's {mesh.data_size} "
                             f"data rows")
        if mesh is not None and cube % (8 * mesh.space_size):
            raise ValueError(f"cube {cube} must be a multiple of 8 x the mesh's "
                             f"{mesh.space_size} space ranks")
        self.space = mesh if mesh is not None and mesh.space_size > 1 else None
        self.swin = isinstance(cfg, swin_unetr.SwinUNETRConfig)
        if self.swin:
            if self.space is not None:
                raise ValueError("Swin UNETR does not split a tile's depth over space ranks")
            fast, train_mode = False, False
            self._forward = self._forward_swin
        self.mesh = mesh
        self.device = resolve_device(device, mesh)
        self.cfg = cfg
        self.cube = cube
        self.step = step
        self.batch = batch
        self.head_idx = {"encoder": 0, "decoder": 1}[head]
        self.use_sigmoid = use_sigmoid
        self.train_mode = train_mode
        self.fast = fast
        self.set_params(params)

    @torch.inference_mode()
    def set_params(self, params) -> "SlidingWindowRunner":
        """Swap the weights (the fast-path transforms are rebuilt once)."""
        if isinstance(params, nn.Module):
            params = params.params_tree()
        self.params = _tree_to(params, self.device)
        if self.swin:
            self.fast_params = swin_unetr.prepare(self.params, self.cfg)
        else:
            self.fast_params = (prepare_fast_params(self.params, self.cfg, n=self.cube // 2)
                                if self.fast else None)
        return self

    def _s2d_io_ok(self, padded_shape, pos: np.ndarray) -> bool:
        """The s2d-folded route needs the fast path, one class, even
        extents and even tile positions, and no mesh; values equal either
        way."""
        if not self.fast or self.mesh is not None or self.cfg.n_classes != 1 or self.cube % 2:
            return False
        if any(int(d) % 2 for d in padded_shape):
            return False
        return not (np.asarray(pos) % 2).any()

    def _forward(self, tiles, train: dict, **kw):
        """The head's scores of one tile batch; `train` holds the model's
        train-mode arguments for this batch (empty in eval mode)."""
        if self.fast:
            outs = apply_fast(self.params, tiles, cfg=self.cfg, fast_params=self.fast_params,
                              space=self.space, **train, **kw)
        else:
            outs = se_unet_apply(self.params, tiles, cfg=self.cfg, space=self.space, **train)
        p = outs[self.head_idx].to(torch.float32)
        return torch.sigmoid(p) if self.use_sigmoid else p

    def _forward_swin(self, tiles, train: dict):
        """Swin UNETR's scores of one tile batch (`_forward` of a Swin runner)."""
        p = swin_unetr.apply(self.params, tiles, cfg=self.cfg,
                             prepared=self.fast_params).to(torch.float32)
        return torch.sigmoid(p) if self.use_sigmoid else p

    def _step(self, vol, pred, positions, shift: float, draws):
        """One tile batch on the full-resolution volume; under a mesh this
        rank's tiles of it (their depth slab over space), the scores of all
        gathered."""
        c = self.cube
        mine, depth = positions, slice(0, c)
        if self.mesh is not None:
            rows = self.mesh.rows(len(positions))
            mine, depth = positions[rows], self.mesh.slab(c)
            if draws:
                draws = self._rank_draws(draws, len(positions), rows)
        raw = torch.stack([vol[x + depth.start : x + depth.stop, y : y + c, z : z + c]
                           for x, y, z in mine])
        p = self._forward(hu_dual_window(raw.to(torch.float32) + shift), draws)[..., 0]
        if self.mesh is not None:
            p = all_gather_rows(all_gather_slabs(p, self.mesh), self.mesh)
        # tiles within a batch may overlap: sequential add per tile
        for i, (x, y, z) in enumerate(positions):
            pred[x : x + c, y : y + c, z : z + c] += p[i]

    def _step_s2d(self, vol_s2d, pred, positions, shift: float, draws):
        """One tile batch against the s2d-folded volume (D/2, H/2,
        (W/2)*8): tiles land in the model's s2d entry layout, the s2d
        heads accumulate without an unfold."""
        n = self.cube // 2
        b = len(positions)
        raw = torch.stack([
            vol_s2d[x // 2 : x // 2 + n, y // 2 : y // 2 + n,
                    (z // 2) * 8 : (z // 2 + n) * 8]
            for x, y, z in positions
        ]).reshape(b, n, n, n, 8)
        # (B,n,n,n,8,2) -> (…,16): phase-major lanes q*2+ch, the
        # space_to_depth entry order
        tiles = hu_dual_window(raw.to(torch.float32) + shift).reshape(b, n, n, n, 16)
        p = self._forward(tiles, draws, x_is_s2d=True, heads_s2d=True).reshape(b, n, n, n * 8)
        for i, (x, y, z) in enumerate(positions):
            pred[x // 2 : x // 2 + n, y // 2 : y // 2 + n,
                 (z // 2) * 8 : (z // 2 + n) * 8] += p[i]

    def _run_volume(self, vol, pos: np.ndarray, s2d_io: bool, shift: float, draws):
        """Probability SUM volume over all tile batches; `draws` holds
        each batch's train-mode arguments (`_draws`)."""
        d, h, w = vol.shape
        batches = [pos[i : i + self.batch].tolist() for i in range(0, len(pos), self.batch)]
        if not s2d_io:
            pred = torch.zeros((d, h, w), dtype=torch.float32, device=self.device)
            for pb, dr in zip(batches, draws):
                with span("runner.tile_batch"):
                    self._step(vol, pred, pb, shift, dr)
            return pred
        d2, h2, w2 = d // 2, h // 2, w // 2
        v = vol.reshape(d2, 2, h2, 2, w2, 2).permute(0, 2, 4, 1, 3, 5)
        v = v.reshape(d2, h2, w2 * 8)
        pred = torch.zeros((d2, h2, w2 * 8), dtype=torch.float32, device=self.device)
        for pb, dr in zip(batches, draws):
            with span("runner.tile_batch"):
                self._step_s2d(v, pred, pb, shift, dr)
        # one per-volume unfold back to voxel order
        pred = pred.reshape(d2, h2, w2, 2, 2, 2).permute(0, 3, 1, 4, 2, 5)
        return pred.reshape(d, h, w)

    def _rank_draws(self, draws: dict, b: int, rows: slice) -> dict:
        """A tile batch's train-mode arguments for this rank: the batch's
        global draws (from the generator when no `drop_draws`) and its rows."""
        dr = draws.get("drop_draws")
        if dr is None:
            dr = draw_dropout(b, self.cfg, draws["generator"])
        return dict(train=True, drop_draws=dr, drop_rows=rows)

    def skip_draws(self, shape, generator: torch.Generator) -> None:
        """Advance `generator` past what a train-mode prediction of a volume
        of `shape` draws from it (one DropLayer draw a tile batch), so ranks
        that split the cases of one generator draw what one process does."""
        if not self.train_mode:
            return
        padded = np.maximum(np.asarray(shape), self.cube)
        pos = pad_positions_to_batch(tile_positions(padded, self.cube, self.step), self.batch)
        for _ in range(len(pos) // self.batch):
            draw_dropout(self.batch, self.cfg, generator)

    def _draws(self, n_batches: int, generator, drop_draws) -> list[dict]:
        """Each tile batch's train-mode arguments of the model: DropLayer
        draws from `generator`, or that batch's `[r_en, r_de]` of
        `drop_draws`; eval mode needs neither and ignores both."""
        if not self.train_mode:
            return [{}] * n_batches
        if drop_draws is None:
            if generator is None:
                raise ValueError("a train-mode runner needs generator= or drop_draws=")
            return [dict(train=True, generator=generator)] * n_batches
        drop_draws = list(drop_draws)
        if len(drop_draws) != n_batches:
            raise ValueError(f"drop_draws holds {len(drop_draws)} batches' draws, "
                             f"the volume has {n_batches} tile batches")
        return [dict(train=True, drop_draws=dr) for dr in drop_draws]

    def _run(self, hu_volume: np.ndarray, hu_shift: float = 0.0, generator=None,
             drop_draws=None):
        # int16 volumes (the stored HU+1024 contract) upload at half the
        # bytes; the shift and the f32 conversion happen on device
        with span("runner.prep"):
            keep = np.int16 if hu_volume.dtype == np.int16 else np.float32
            vol_np, orig_shape = _pad_to_cube(hu_volume.astype(keep), self.cube,
                                              fill=-1024.0 - hu_shift)
            pos = tile_positions(vol_np.shape, self.cube, self.step)
            pos = pad_positions_to_batch(pos, self.batch)
            draws = self._draws(len(pos) // self.batch, generator, drop_draws)
            vol = torch.from_numpy(np.ascontiguousarray(vol_np)).to(self.device)
        pred = self._run_volume(vol, pos, self._s2d_io_ok(vol_np.shape, pos),
                                float(hu_shift), draws)
        # queued after the tile batches, so no count volume lives through the forward
        with span("runner.inv_count"):
            inv_cnt = inv_overlap_count(vol_np.shape, pos, self.cube, self.device)
        return pred, inv_cnt, vol_np.shape, orig_shape

    @staticmethod
    def _trits(pred, inv_cnt, h_thresh: float, l_thresh: float):
        avg = pred * inv_cnt
        trit = (avg >= l_thresh).to(torch.uint8) + (avg >= h_thresh).to(torch.uint8)
        return trit.reshape(-1)

    @staticmethod
    def _pack5(t5):
        return (t5[..., 0] + 3 * t5[..., 1] + 9 * t5[..., 2] + 27 * t5[..., 3]
                + 81 * t5[..., 4])

    @staticmethod
    def _trit_summary(pred, inv_cnt, h_thresh: float, l_thresh: float):
        """Block codec: per-block (min<<2 | max) summary byte, the base-3
        payload, and the payload split into BLOCKS_PER_CHUNK-block chunks."""
        trit = SlidingWindowRunner._trits(pred, inv_cnt, h_thresh, l_thresh)
        pad = (-trit.shape[0]) % VOX_PER_BLOCK
        if pad:
            trit = torch.cat([trit, trit.new_zeros(pad)])
        tb = trit.reshape(-1, VOX_PER_BLOCK)
        summary = tb.amin(dim=1) * 4 + tb.amax(dim=1)
        payload = SlidingWindowRunner._pack5(tb.reshape(tb.shape[0], VOX_PER_BLOCK // 5, 5))
        cpad = (-tb.shape[0]) % BLOCKS_PER_CHUNK
        if cpad:
            # padded blocks summarize as constant-0 and fall off n_voxels
            payload = torch.cat([payload, payload.new_zeros((cpad, VOX_PER_BLOCK // 5))])
            summary = torch.cat([summary, summary.new_zeros(cpad)])
        chunks = tuple(payload[i : i + BLOCKS_PER_CHUNK].reshape(-1)
                       for i in range(0, payload.shape[0], BLOCKS_PER_CHUNK))
        return summary, chunks, payload.reshape(-1)

    @staticmethod
    def _trit_pack(pred, inv_cnt, h_thresh: float, l_thresh: float):
        """The whole trit field, base-3 at 5 voxels a byte."""
        trit = SlidingWindowRunner._trits(pred, inv_cnt, h_thresh, l_thresh)
        pad = (-trit.shape[0]) % 5
        if pad:
            trit = torch.cat([trit, trit.new_zeros(pad)])
        return SlidingWindowRunner._pack5(trit.reshape(-1, 5))

    @torch.inference_mode()
    def predict_hu(self, hu_volume: np.ndarray, hu_shift: float = 0.0, *,
                   generator: torch.Generator | None = None,
                   drop_draws=None) -> np.ndarray:
        """HU volume (D, H, W) -> float32 averaged score volume. `hu_shift`
        is added on device (-1024 for stored int16 HU+1024 volumes).
        `generator` / `drop_draws`: the DropLayer draws in train mode."""
        with span("runner.volume"):
            pred, inv_cnt, _, orig = self._run(hu_volume, hu_shift, generator, drop_draws)
        out = (pred * inv_cnt).cpu().numpy()
        d, h, w = orig
        return out[:d, :h, :w]

    @torch.inference_mode()
    def predict_trits_device(self, hu_volume: np.ndarray, *, h_thresh: float = 0.5,
                             l_thresh: float = 0.4, hu_shift: float = 0.0,
                             generator: torch.Generator | None = None, drop_draws=None):
        """(packed device tensor, padded_shape, orig_shape), not fetched."""
        with span("runner.volume"):
            pred, inv_cnt, padded_shape, orig = self._run(hu_volume, hu_shift, generator,
                                                          drop_draws)
            packed = self._trit_pack(pred, inv_cnt, float(h_thresh), float(l_thresh))
        return packed, padded_shape, orig

    @torch.inference_mode()
    def predict_trits_summary_device(self, hu_volume: np.ndarray, *,
                                     h_thresh: float = 0.5, l_thresh: float = 0.4,
                                     hu_shift: float = 0.0,
                                     generator: torch.Generator | None = None,
                                     drop_draws=None):
        """(summary, payload_chunks, payload, padded_shape, orig_shape),
        all on the device, queued and not waited for."""
        with span("runner.volume"):
            pred, inv_cnt, padded_shape, orig = self._run(hu_volume, hu_shift, generator,
                                                          drop_draws)
            summary, chunks, payload = self._trit_summary(pred, inv_cnt, float(h_thresh),
                                                          float(l_thresh))
        return summary, chunks, payload, padded_shape, orig

    def predict_trits(self, hu_volume: np.ndarray, *, h_thresh: float = 0.5,
                      l_thresh: float = 0.4, hu_shift: float = 0.0,
                      generator: torch.Generator | None = None,
                      drop_draws=None) -> np.ndarray:
        """HU volume -> uint8 trit volume (0 below / 1 band / 2 seed),
        thresholded and packed on device, decoded on the host from the
        summary and the mixed blocks' payload."""
        out = self.predict_trits_summary_device(
            hu_volume, h_thresh=h_thresh, l_thresh=l_thresh, hu_shift=hu_shift,
            generator=generator, drop_draws=drop_draws)
        return fetch_trits(out)


def fetch_trits(out) -> np.ndarray:
    """Copy and decode the output of `predict_trits_summary_device` to
    the uint8 trit volume of the original extent."""
    summary, chunks, payload, padded_shape, orig = out
    with span("runner.fetch"):
        s = _host(summary)
        with span("runner.decode"):
            trits = decode_trit_summary(s, make_chunk_fetcher(s, chunks, payload),
                                        int(np.prod(padded_shape)), padded_shape)
    d, h, w = orig
    return trits[:d, :h, :w]
