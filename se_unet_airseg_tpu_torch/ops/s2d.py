"""Space-to-depth (s2d) algebra for the full-resolution UNet levels
(eval-path subset of the JAX package's `ops/s2d.py`).

Each 2x2x2 block of voxels folds into the channel axis, sub-position
major: (B, 2n, 2n, 2n, C) <-> (B, n, n, n, 8C), lane p*C + c with
p = dz*4 + dy*2 + dx. The convolutions of the full-resolution level are
rewritten exactly on the folded tensors:

  * `conv3_weight_to_s2d`: a 3^3 pad-1 kernel lifted to a 3^3 block
    kernel (8x the FLOPs; used for the narrow ec1/ec2);
  * `dil2_group_weight`: a dilation-2 3^3 conv is 8 independent dil-1
    convs on the sub-grids, run as a grouped conv with ng groups, each
    holding the block-diagonal dense kernel of 8/ng sub-positions;
  * `phased_conv_weights`: all 8 output sub-positions from ONE 2^3
    block conv with phase-stacked output channels; phase q then takes a
    shifted window of the (n+1)^3 output (the "phased" conv);
  * `upsample_to_s2d`: align_corners trilinear upsampling emitted
    straight into s2d layout.

Weights are DHWIO, as in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import product

import numpy as np
import torch

from .conv import conv3d
from .norms import leaky_relu
from .resize import _interp_matrix, contract_axis


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, 2n, 2n, 2n, C) -> (B, n, n, n, 8C), p-major channels."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, d // 2, h // 2, w // 2, 8 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(B, n, n, n, 8C) -> (B, 2n, 2n, 2n, C)."""
    b, d, h, w, c8 = x.shape
    c = c8 // 8
    x = x.reshape(b, d, h, w, 2, 2, 2, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, 2 * d, 2 * h, 2 * w, c)


@lru_cache(maxsize=None)
def _block_lift_tensor() -> np.ndarray:
    """M[Sz,Sy,Sx, p_in, p_out, dz,dy,dx] in {0,1}: tap (d) of output
    sub-position p_out reads input sub-position p_in at block offset S."""
    m = np.zeros((3, 3, 3, 8, 8, 3, 3, 3), np.float32)
    for a, bb, c in product(range(2), repeat=3):
        q = a * 4 + bb * 2 + c
        for dz, dy, dx in product((-1, 0, 1), repeat=3):
            sz, az = divmod(a + dz + 2, 2)
            sy, ay = divmod(bb + dy + 2, 2)
            sx, ax = divmod(c + dx + 2, 2)
            p = az * 4 + ay * 2 + ax
            m[sz, sy, sx, p, q, dz + 1, dy + 1, dx + 1] = 1.0
    return m


def conv3_weight_to_s2d(w: torch.Tensor) -> torch.Tensor:
    """(3,3,3,Ci,Co) -> (3,3,3,8Ci,8Co) block kernel (dil=1, pad=1)."""
    ci, co = w.shape[3], w.shape[4]
    m = torch.from_numpy(_block_lift_tensor()).to(w.device, w.dtype)
    wp = torch.einsum("ZYXpqdef,defio->ZYXpiqo", m, w)
    return wp.reshape(3, 3, 3, 8 * ci, 8 * co)


def bias_to_s2d(b: torch.Tensor) -> torch.Tensor:
    """(Co,) -> (8Co,) tiled per sub-position."""
    return b.repeat(8)


def _eye8(like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.eye(8, dtype=dtype or like.dtype, device=like.device)


def grouped_pointwise(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None = None) -> torch.Tensor:
    """1x1x1 conv on an s2d tensor: weights (Ci, Co) shared across the 8
    sub-positions, as one (..., 8Ci) @ kron(I8, w) matmul."""
    wd = torch.kron(_eye8(x), w.to(x.dtype).contiguous())
    y = x @ wd
    if b is not None:
        y = y + b.repeat(8).to(y.dtype)
    return y


def grouped_pointwise_multi_weight(w: torch.Tensor, channel_counts: tuple,
                                   dtype) -> torch.Tensor:
    """Block-diagonal weight of a 1x1x1 conv over a PLAIN concat of s2d
    tensors: W[off8_t + p*c_t + i, p*co + o] = w[cum_t + i, o]."""
    eye = _eye8(w, dtype)
    parts, cum = [], 0
    for c_t in channel_counts:
        parts.append(torch.kron(eye, w[cum : cum + c_t].to(dtype).contiguous()))
        cum += c_t
    return torch.cat(parts, dim=0)


def grouped_pointwise_multi_pre(xs: list, wd: torch.Tensor,
                                b: torch.Tensor | None = None):
    """1x1x1 conv of the concat of `xs` without building the concat:
    each tensor contracts against its own row block of `wd`."""
    y, off = None, 0
    for t in xs:
        k = t.shape[-1]
        yt = t @ wd[off : off + k]
        y = yt if y is None else y + yt
        off += k
    if b is not None:
        y = y + b.repeat(8).to(y.dtype)
    return y


@lru_cache(maxsize=None)
def plain_to_interleaved_perm(channel_counts: tuple) -> tuple:
    """perm[plain_idx] = interleaved_idx for a plain concat of s2d
    tensors with original channel counts `channel_counts`."""
    total = sum(channel_counts)
    perm, cum = [], 0
    for c_t in channel_counts:
        for p in range(8):
            for i in range(c_t):
                perm.append(p * total + cum + i)
        cum += c_t
    return tuple(perm)


def instance_norm_s2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over (D, H, W, 8 sub-positions) per original channel,
    one-pass f32 statistics (var = E[x^2] - E[x]^2, clamped at 0)."""
    b, d, h, w, c8 = x.shape
    c = c8 // 8
    n = d * h * w * 8
    xf = x.to(torch.float32)
    s1 = xf.sum(dim=(1, 2, 3))
    s2 = torch.square(xf).sum(dim=(1, 2, 3))
    mean = s1.reshape(b, 8, c).sum(1) / n
    ex2 = s2.reshape(b, 8, c).sum(1) / n
    var = torch.clamp(ex2 - torch.square(mean), min=0.0)
    scale = torch.rsqrt(var + eps)
    scale8 = scale.repeat(1, 8)[:, None, None, None, :]
    shift8 = (mean * scale).repeat(1, 8)[:, None, None, None, :]
    return (xf * scale8 - shift8).to(x.dtype)


def dil2_dense_weight(w: torch.Tensor, dtype) -> torch.Tensor:
    """Block-diagonal dense lift of a dil-2 kernel on s2d tensors:
    (3,3,3,Ci,Co) -> (3,3,3,8Ci,8Co), w on the 8 diagonal blocks."""
    k, ci, co = w.shape[0], w.shape[3], w.shape[4]
    wd = torch.einsum("dhwio,gk->dhwgiko", w.to(dtype), _eye8(w, dtype))
    return wd.reshape(k, k, k, 8 * ci, 8 * co)


def dil2_group_weight(w: torch.Tensor, ng: int, dtype) -> torch.Tensor:
    """Partial-dense lift for a groups=ng conv: ng groups of 8/ng
    sub-positions, block-diagonal dense within each group ->
    (3,3,3,(8/ng)Ci, 8Co)."""
    ci, co = w.shape[3], w.shape[4]
    per = 8 // ng
    wd = dil2_dense_weight(w, dtype)
    return torch.cat(
        [wd[:, :, :, g * per * ci : (g + 1) * per * ci,
            g * per * co : (g + 1) * per * co] for g in range(ng)],
        dim=4,
    )


def se_gate_weights(w_se: torch.Tensor, dtype):
    """(wg (8Ci, 8), onehot (8, 8Ci)) for `se_gate_s2d_pre`; `w_se` is
    the reference (Ci, 1) kernel."""
    ci = w_se.shape[0]
    eye = _eye8(w_se, dtype)
    wg = torch.kron(eye, w_se.to(dtype).contiguous())
    onehot = torch.kron(eye, torch.ones((1, ci), dtype=dtype, device=w_se.device))
    return wg, onehot


def se_gate_s2d_pre(x: torch.Tensor, wg: torch.Tensor, onehot: torch.Tensor):
    """Spatial SE gate on an s2d tensor: per original voxel
    sigmoid(<features, w>), broadcast over that voxel's channels."""
    gate = torch.sigmoid(x @ wg)
    return x * (gate @ onehot)


def max_pool_s2d(x: torch.Tensor) -> torch.Tensor:
    """MaxPool3d(2, 2) of the underlying image: the maximum over the 8
    sub-positions, (B, n, n, n, 8C) -> (B, n, n, n, C)."""
    return x.unflatten(-1, (8, x.shape[-1] // 8)).amax(dim=-2)


@lru_cache(maxsize=None)
def _interp_pair(n_in: int, n_out_full: int) -> np.ndarray:
    """(2, n_out_full//2, n_in): even/odd rows of the align_corners
    interpolation matrix."""
    m = _interp_matrix(n_in, n_out_full)
    return np.stack([m[0::2], m[1::2]])


def upsample_to_s2d(x: torch.Tensor, scale: int, pair=None) -> torch.Tensor:
    """Trilinear align_corners upsample of (B, m, m, m, C) by `scale`,
    emitted in s2d layout (B, m*scale/2, ..., 8C). bf16 inputs contract
    in bf16 (one rounding per axis), f32 inputs in f32. `pair` is the
    precomputed (2, m*scale/2, m) even/odd matrix of a cube."""
    b, d, h, w, c = x.shape
    ct = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    mats = []
    for ext in (d, h, w):
        pr = pair if pair is not None else torch.from_numpy(_interp_pair(ext, ext * scale))
        pr = pr.to(device=x.device, dtype=ct)
        # interleave the even/odd rows back into the full matrix
        mats.append(pr.transpose(0, 1).reshape(-1, pr.shape[-1]))
    y = x.to(ct)
    for axis, m in zip((1, 2, 3), mats):
        y = contract_axis(m, y, axis)
    return space_to_depth(y).to(x.dtype)


def _phase_lift_tensor(a: int, b: int, c: int) -> np.ndarray:
    """Mq[sz',sy',sx', p_in, dz,dy,dx] in {0,1} for output sub-position
    (a, b, c): which original tap each 2^3 block tap x input
    sub-position contributes."""
    m = np.zeros((2, 2, 2, 8, 3, 3, 3), np.float32)
    for szp, syp, sxp in product(range(2), repeat=3):
        for az, ay, ax in product(range(2), repeat=3):
            dz = a - 2 + 2 * szp + az
            dy = b - 2 + 2 * syp + ay
            dx = c - 2 + 2 * sxp + ax
            if all(-1 <= v <= 1 for v in (dz, dy, dx)):
                p = az * 4 + ay * 2 + ax
                m[szp, syp, sxp, p, dz + 1, dy + 1, dx + 1] = 1.0
    return m


def phased_conv_weights(w: torch.Tensor, b: torch.Tensor | None = None,
                        in_splits: tuple | None = None):
    """Lift (3,3,3,Ci,Co) to the phase-stacked 2^3 block kernel:
    (w_all (2,2,2,8Ci,8Co), b_all (8Co,)), output channels q-major;
    with `in_splits` the input rows are permuted for a PLAIN concat of
    s2d tensors with those original channel counts."""
    ci, co = w.shape[3], w.shape[4]
    kernels = []
    for a, bb, c in product(range(2), repeat=3):
        m = torch.from_numpy(_phase_lift_tensor(a, bb, c)).to(w.device, w.dtype)
        wq = torch.einsum("ZYXpdef,defio->ZYXpio", m, w)
        kernels.append(wq.reshape(2, 2, 2, 8 * ci, co))
    w_all = torch.cat(kernels, dim=-1)
    if in_splits is not None:
        perm = torch.tensor(plain_to_interleaved_perm(tuple(in_splits)),
                            device=w.device)
        w_all = w_all[:, :, :, perm, :]
    b_all = b.repeat(8) if b is not None else None
    return w_all, b_all


def phased_conv_ext(xs: list, w_all: torch.Tensor,
                    b_all: torch.Tensor | None) -> torch.Tensor:
    """The phased conv's ungathered output (B, n+1, n+1, n+1, 8Co) for a
    list of s2d tensors forming a plain concat: the concat never
    materializes (the conv is linear in its input channels, so the
    per-input partial convs sum)."""
    y, off = None, 0
    for t in xs:
        k = t.shape[-1]
        yt = conv3d(t, w_all[:, :, :, off : off + k, :],
                    b_all if y is None else None, padding=1)
        y = yt if y is None else y + yt
        off += k
    return y


def phase_windows(y_ext: torch.Tensor, n: int) -> list:
    """The 8 phase windows y_ext[:, a:a+n, b:b+n, c:c+n, qC:(q+1)C]."""
    co = y_ext.shape[-1] // 8
    return [
        y_ext[:, a : a + n, bb : bb + n, c : c + n, q * co : (q + 1) * co]
        for q, (a, bb, c) in enumerate(product(range(2), repeat=3))
    ]


def conv3_s2d_phased_fused(xs, w_all: torch.Tensor,
                           b_all: torch.Tensor | None, eps: float = 1e-5):
    """Phased conv + InstanceNorm + LeakyReLU: statistics from the conv's
    (n+1)^3 phase windows, normalize+activate per window inside the
    final concat. `xs` is one s2d tensor or a list forming a plain
    concat."""
    xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
    n = xs[0].shape[1]
    slices = phase_windows(phased_conv_ext(xs, w_all, b_all), n)
    s1 = sum(sl.to(torch.float32).sum(dim=(1, 2, 3)) for sl in slices)
    s2 = sum(torch.square(sl.to(torch.float32)).sum(dim=(1, 2, 3)) for sl in slices)
    nvox = 8 * n * n * n
    mean = s1 / nvox
    var = torch.clamp(s2 / nvox - torch.square(mean), min=0.0)
    scale = torch.rsqrt(var + eps)[:, None, None, None, :]
    shift = mean[:, None, None, None, :] * scale
    acts = [leaky_relu(sl.to(torch.float32) * scale - shift).to(xs[0].dtype)
            for sl in slices]
    return torch.cat(acts, dim=-1)
