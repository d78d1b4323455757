"""Fused InstanceNorm + LeakyReLU(0.01) over (B, S, C), forward and
backward.

Counterpart of the JAX package's `ops/pallas_norm.py`
(`instance_norm_leaky`, Pallas forward :139, backward :176). No model path
calls it; it is its own entry point, with the s2d and NDHWC wrappers of
the JAX module. Both passes are CUDA kernels here (`csrc/norm_leaky.cu`,
built and bound by `ops/cuda_lib.py`), at the JAX kernels' rounding
points:

  * forward: per (b, c) over S, f32 sums s1 = sum(x), s2 = sum(x^2);
    mean = s1 / S, var = s2 / S - mean^2 (NOT clamped),
    rstd = rsqrt(var + 1e-5); y = LeakyReLU((x - mean) * rstd) with the
    f32 slope 0.01 (not the slope rounded to x's dtype of
    `ops/norms.py::leaky_relu`), rounded once to x's dtype;
  * backward, from the saved ROUNDED y and rstd: xhat = y >= 0 ? y :
    y / 0.01, g' = y >= 0 ? g : 0.01 g, dx = rstd * (g' - mean(g') -
    xhat * mean(g' xhat)), rounded once to g's dtype.

Both directions stream 16-byte vectors of their inputs (x; g and y)
through a bulk-copy ring in shared memory, or load them into registers
where rows are wider than a block row or C or a base does not allow
vectors (`design`; the partition is `partition_plain`, the division
`div_slope_plain`).
Each wrapper takes its plain PyTorch version (`*_plain`) for a CPU tensor
only; on a CUDA tensor it launches its kernel or raises. Each counts its
launches in `cuda_lib.launch_counts`.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from .cuda_lib import _DTYPE_CODE, F32, _acc, _on_card, _stream, launch

EPS = 1e-5
SLOPE = 0.01


# ----------------------------------------------------------- plain versions


def instance_norm_leaky_plain(x):
    """Plain PyTorch version of the forward: x (B, S, C) -> (y in x's
    dtype, rstd (B, C) f32)."""
    xf = x.to(_acc(x.dtype))
    s = x.shape[1]
    mean = xf.sum(1) / s
    var = torch.square(xf).sum(1) / s - mean * mean
    rstd = torch.rsqrt(var + EPS)
    y = (xf - mean[:, None]) * rstd[:, None]
    return torch.where(y >= 0, y, y * SLOPE).to(x.dtype), rstd


def instance_norm_leaky_bwd_plain(g, y, rstd):
    """Plain PyTorch version of the backward: the cotangent g and the
    forward's y (B, S, C), its rstd (B, C) -> dx in g's dtype."""
    acc = _acc(g.dtype)
    gf, yf = g.to(acc), y.to(acc)
    pos = yf >= 0
    gy = torch.where(pos, gf, gf * SLOPE)
    xhat = torch.where(pos, yf, yf / SLOPE)
    s = y.shape[1]
    m1 = gy.sum(1) / s
    m2 = (gy * xhat).sum(1) / s
    dx = rstd[:, None] * (gy - m1[:, None] - xhat * m2[:, None])
    return dx.to(g.dtype)


# ----------------------------------------- the kernels' partition and rules


def div_slope_plain(y):
    """The backward kernels' y / 0.01 (`div_slope` in csrc/norm_leaky.cu)
    on float32 numpy values: q = RN(y * RN(1 / 0.01)), corrected once by
    the remainder y - q * 0.01, each fused product-sum rounded once
    (evaluated exactly in rational arithmetic); outside
    2^-100 <= |y| < 2^100 the IEEE quotient. Equal to y / 0.01 in IEEE
    float32."""
    f32 = np.float32
    d, r = f32(SLOPE), f32(1) / f32(SLOPE)
    y = np.asarray(y, dtype=f32)
    with np.errstate(over="ignore"):
        out = (y / d).astype(f32)
    for i in np.flatnonzero((np.abs(y) >= 2.0 ** -100) & (np.abs(y) < 2.0 ** 100)):
        q = f32(y.flat[i] * r)
        rem = _round32(Fraction(float(y.flat[i])) - Fraction(float(q)) * Fraction(float(d)))
        out.flat[i] = _round32(Fraction(float(q)) + Fraction(float(rem)) * Fraction(float(r)))
    return out


def _round32(x):
    """The float32 nearest to the rational x (ties to even)."""
    c = np.float32(float(x))
    cands = (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.float32(v).view(np.uint32)) & 1))


def vector_width(c: int, elt: int, aligned: bool) -> int:
    """Channels per thread of both directions' kernels: one 16-byte vector
    where C is a multiple of it and every base is 16-byte aligned, else 1
    (`run` in csrc/norm_leaky.cu)."""
    v = 16 // elt
    return v if c % v == 0 and aligned else 1


RING_BYTES = 16384  # the ring's stage, per input (`kRingBytes`)
RING_SLOTS = 6      # stages x inputs: a 96 KB ring (`kRingSlots`)


def ring_stages(bwd: bool) -> int:
    """The ring's depth: 6 stages of x forward, 3 of g and y backward."""
    return RING_SLOTS // (2 if bwd else 1)


def uses_ring(c: int, elt: int, aligned: bool) -> bool:
    """Whether the kernels stream through the bulk-copy ring (chosen by
    shape before the launch, `run` in csrc/norm_leaky.cu): where a thread's
    vector fills 16 bytes and a block row covers whole rows; else they
    load V channels into registers."""
    v = vector_width(c, elt, aligned)
    return v * elt == 16 and c // v <= 256


def design(c: int, elt: int, aligned: bool, bwd: bool) -> str:
    """A direction's form at this shape, named for the chip_smoke.py
    lines."""
    if uses_ring(c, elt, aligned):
        return f"16-byte vectors, bulk-copy ring of {ring_stages(bwd)} stages, two passes"
    return f"{vector_width(c, elt, aligned)}-channel register loads, two passes"


def partition_plain(b: int, s: int, c: int, elt: int, aligned: bool, blocks: int):
    """Both directions' partition of (B, S, C) over a grid of about
    `blocks` blocks of 256 threads (`vplan`, `vlane`, `ring_kernel` in
    csrc/norm_leaky.cu): per block (chunk, channel tile, batch entry) and
    thread, the (b, row, first channel) of the V-channel vectors it reads,
    in order, in each pass. Where V fills 16 bytes and a block row covers
    whole rows, the block's rows come in ring stages of RING_BYTES per
    input, the thread taking rows slot, slot + pass, ... of each stage;
    otherwise the thread takes rows r0 + slot, r0 + slot + pass, ... of its
    chunk. Returns (V, ring, grid, {(block, thread): [...]})."""
    v = vector_width(c, elt, aligned)
    cv = c // v
    width = min(cv, 256)
    step = 256 // width
    ring = uses_ring(c, elt, aligned)
    ctiles = -(-cv // width)
    chunks = max(1, min(-(-blocks // (b * ctiles)), -(-s // step)))
    chunk = -(-s // chunks)
    grid = (-(-s // chunk), ctiles, b)
    stage_rows = RING_BYTES // (c * elt)
    parts = {}
    for bx in range(grid[0]):
        r0, r1 = bx * chunk, min(bx * chunk + chunk, s)
        for by in range(ctiles):
            for bz in range(b):
                for tid in range(256):
                    slot, cvi = tid // width, by * width + tid % width
                    if slot >= step or cvi >= cv:
                        continue
                    if ring:
                        rows = [r for k0 in range(r0, r1, stage_rows)
                                for r in range(k0 + slot, min(k0 + stage_rows, r1), step)]
                    else:
                        rows = range(r0 + slot, r1, step)
                    parts[(bx, by, bz), tid] = [(bz, r, cvi * v) for r in rows]
    return v, ring, grid, parts


# ------------------------------------------------------------- wrappers


def _check(t, name, like=None):
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"the norm kernels take float32 or bfloat16, got {t.dtype}")
    if t.dim() != 3 or t.numel() == 0:
        raise ValueError(f"{name} must be a non-empty (B, S, C) tensor, got {tuple(t.shape)}")
    if like is not None and (t.shape != like.shape or t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f"{name} must be a {like.dtype} {tuple(like.shape)} tensor on "
                         f"{like.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _norm_leaky_fwd(x):
    if not _on_card(x):
        return instance_norm_leaky_plain(x)
    x = _check(x, "x")
    b, s, c = x.shape
    y = torch.empty_like(x)
    sums = torch.zeros((2, b, c), dtype=F32, device=x.device)
    rstd = torch.empty((b, c), dtype=F32, device=x.device)
    with torch.cuda.device(x.device):
        launch("airseg_norm_leaky_fwd", "instance_norm_leaky_fwd", _DTYPE_CODE[x.dtype],
               x.data_ptr(), y.data_ptr(), sums.data_ptr(), rstd.data_ptr(), b, s, c,
               _stream(x))
    return y, rstd


def _norm_leaky_bwd(g, y, rstd):
    if not _on_card(g):
        return instance_norm_leaky_bwd_plain(g, y, rstd)
    g = _check(g, "g")
    y = _check(y, "y", like=g)
    b, s, c = g.shape
    if rstd.dtype != F32 or rstd.shape != (b, c) or rstd.device != g.device:
        raise ValueError(f"rstd must be a float32 ({b}, {c}) tensor on {g.device}")
    rstd = rstd.contiguous()
    dx = torch.empty_like(g)
    sums = torch.zeros((2, b, c), dtype=F32, device=g.device)
    with torch.cuda.device(g.device):
        launch("airseg_norm_leaky_bwd", "instance_norm_leaky_bwd", _DTYPE_CODE[g.dtype],
               g.data_ptr(), y.data_ptr(), rstd.data_ptr(), dx.data_ptr(), sums.data_ptr(),
               b, s, c, _stream(g))
    return dx


class _InstanceNormLeaky(torch.autograd.Function):
    """instance_norm_leaky under autograd: saves the rounded y and rstd;
    backward = the backward kernel (the custom vjp of pallas_norm.py:163-195)."""

    @staticmethod
    def forward(ctx, x):
        y, rstd = _norm_leaky_fwd(x)
        ctx.save_for_backward(y, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        y, rstd = ctx.saved_tensors
        return _norm_leaky_bwd(g.to(y.dtype), y, rstd)


def instance_norm_leaky(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(InstanceNorm(x)) of x (B, S, C), statistics per (b, c)
    over S. Replaces pallas_norm.instance_norm_leaky."""
    return _InstanceNormLeaky.apply(x)


def instance_norm_leaky_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) wrapper: statistics per (b, c) over D, H, W."""
    b, d, h, w, c = x.shape
    return instance_norm_leaky(x.reshape(b, d * h * w, c)).reshape(b, d, h, w, c)


def instance_norm_leaky_s2d(x: torch.Tensor) -> torch.Tensor:
    """s2d wrapper (B, n, n, n, 8C): statistics per ORIGINAL channel,
    over space x the 8 sub-positions."""
    b, d, h, w, c8 = x.shape
    return instance_norm_leaky(x.reshape(b, d * h * w * 8, c8 // 8)).reshape(b, d, h, w, c8)
