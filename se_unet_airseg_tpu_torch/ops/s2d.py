"""Space-to-depth (s2d) algebra for the full-resolution UNet levels
(the subset of the JAX package's `ops/s2d.py` that the fast path runs).

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
    straight into s2d layout;
  * `max_pool_s2d`: the 2x2x2 max pool as a maximum over the 8
    sub-positions; its backward (a CUDA kernel on the card) splits the
    cotangent evenly among tied maxima;
  * `instance_norm_from_stats`: InstanceNorm of an s2d tensor from the
    per-lane sums a fused conv emits (ops/conv_stats.py);
  * `to_polyphase` / `from_polyphase`: sub-positions to batch entries and
    back (the dil-2 conv as one dil-1 conv, the plain form of
    `dil2_conv_stats`).

Weights are DHWIO, as in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import product

import numpy as np
import torch

from ..parallel.mesh import halo, space_sum
from .conv import conv3d
from .cuda_lib import launch
from .resize import _interp_matrix, contract_axis, slab_matrix


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


def instance_norm_s2d(x: torch.Tensor, eps: float = 1e-5, space=None) -> torch.Tensor:
    """InstanceNorm over (D, H, W, 8 sub-positions) per original channel,
    one-pass f32 statistics (var = E[x^2] - E[x]^2, clamped at 0); with
    `space`, of the whole crop from this rank's depth slab."""
    xf = x.to(torch.float32)
    return instance_norm_from_stats(x, xf.sum(dim=(1, 2, 3)),
                                    torch.square(xf).sum(dim=(1, 2, 3)), eps, space)


def _affine8(s1, s2, nvox: int, eps: float):
    """(B, C) sums of y and y^2 over `nvox` values -> the phase-tiled
    (B, 8C) InstanceNorm scale8 and shift8 (var = E[y^2] - mean^2 clamped
    at 0, scale = rsqrt(var + eps), shift = mean * scale)."""
    mean = s1 / nvox
    var = torch.clamp(s2 / nvox - torch.square(mean), min=0.0)
    scale = torch.rsqrt(var + eps)
    return scale.repeat(1, 8).contiguous(), (mean * scale).repeat(1, 8).contiguous()


def instance_norm_from_stats(y: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
                             eps: float = 1e-5, space=None) -> torch.Tensor:
    """InstanceNorm of an s2d tensor y (B, n, n, n, 8C) from its per-lane
    sums s1, s2 (B, 8C) (the outputs of `phased_conv_stats` /
    `dil2_conv_stats`): the 8 sub-positions' sums add per original
    channel, then y * scale8 - shift8 in f32, rounded once to y's dtype.
    `space` (a `parallel.DataMesh`): y is this rank's depth slab, s1 and
    s2 its sums, which add over the space ranks (`parallel.space_sum`);
    the count is the whole crop's."""
    b, d, h, w, c8 = y.shape
    c = c8 // 8
    s12 = torch.stack([s1.reshape(b, 8, c).sum(1), s2.reshape(b, 8, c).sum(1)])
    n_space = 1
    if space is not None:
        s12, n_space = space_sum(s12, space), space.space_size
    scale8, shift8 = _affine8(s12[0], s12[1], 8 * d * h * w * n_space, eps)
    bshape = (b, 1, 1, 1, c8)
    return (y.to(scale8.dtype) * scale8.reshape(bshape) - shift8.reshape(bshape)).to(y.dtype)


def to_polyphase(x: torch.Tensor) -> torch.Tensor:
    """s2d (B, n, n, n, 8C) -> (8B, n, n, n, C): sub-positions become
    batch entries (batch b, sub-position p -> entry 8b + p)."""
    b, d, h, w, c8 = x.shape
    c = c8 // 8
    x = x.reshape(b, d, h, w, 8, c).permute(0, 4, 1, 2, 3, 5)
    return x.reshape(b * 8, d, h, w, c)


def from_polyphase(x: torch.Tensor) -> torch.Tensor:
    """Inverse of `to_polyphase`."""
    b8, d, h, w, c = x.shape
    x = x.reshape(b8 // 8, 8, d, h, w, c).permute(0, 2, 3, 4, 1, 5)
    return x.reshape(b8 // 8, d, h, w, 8 * c)


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


def _max_pool_s2d_fwd(x: torch.Tensor) -> torch.Tensor:
    return x.unflatten(-1, (8, x.shape[-1] // 8)).amax(dim=-2)


def max_pool_s2d_bwd_plain(x: torch.Tensor, g: torch.Tensor | None = None):
    """Plain PyTorch version of the pool backward kernel. Per (voxel,
    channel) of x (B, n, n, n, 8C), compared in f32: with g (B, n, n, n,
    C) it returns dx, whose tied maxima each get dtype(g / n_ties) and
    every other lane 0; without g the mask with dtype(1 / n_ties)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    x8 = x.unflatten(-1, (8, x.shape[-1] // 8)).to(acc)
    eq = x8 == x8.amax(dim=-2, keepdim=True)
    cnt = eq.sum(dim=-2, keepdim=True).to(acc)
    if g is None:
        val = (1.0 / cnt).to(x.dtype)
    else:
        val = (g.unsqueeze(-2).to(acc) / cnt).to(g.dtype)
    return torch.where(eq, val, 0.0).flatten(-2)


def max_pool_s2d_bwd(x: torch.Tensor, g: torch.Tensor | None = None):
    """Backward of `max_pool_s2d` in one pass over x (CUDA kernel
    `csrc/pool_s2d.cu`; replaces max_pool_s2d_bwd_mask). With the
    cotangent g it returns dx; without, the tie-split mask. Takes the
    plain version for a CPU tensor only; on a CUDA tensor it launches
    the kernel or raises. Any channel width."""
    if x.device.type == "cpu":
        return max_pool_s2d_bwd_plain(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    code = {torch.float32: 0, torch.bfloat16: 1}.get(x.dtype)
    if code is None:
        raise TypeError(f"the pool backward kernel takes float32 or bfloat16, got {x.dtype}")
    c8 = x.shape[-1]
    if c8 % 8 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (..., 8C) tensor, got {tuple(x.shape)}")
    c = c8 // 8
    x = x.contiguous()
    if g is not None:
        if g.shape != x.shape[:-1] + (c,) or g.dtype != x.dtype or g.device != x.device:
            raise ValueError(f"g must be a {x.dtype} {tuple(x.shape[:-1]) + (c,)} tensor "
                             f"on {x.device}")
        g = g.contiguous()
    out = torch.empty_like(x)
    vec = 16 // x.element_size()
    ptrs = [t.data_ptr() for t in (x, out, g) if t is not None]
    if c % vec or any(p % 16 for p in ptrs):
        vec = 1
    with torch.cuda.device(x.device):
        launch("airseg_max_pool_s2d_bwd", "max_pool_s2d_bwd", code,
               x.data_ptr(), None if g is None else g.data_ptr(), out.data_ptr(),
               x.numel() // c8, c, vec, torch.cuda.current_stream(x.device).cuda_stream)
    return out


class _MaxPoolS2d(torch.autograd.Function):
    """max_pool_s2d under autograd: saves x only; backward splits the
    cotangent evenly among tied maxima (the custom vjp of the JAX
    package's s2d.py:210-276)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _max_pool_s2d_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return max_pool_s2d_bwd(x, g)


def max_pool_s2d(x: torch.Tensor) -> torch.Tensor:
    """MaxPool3d(2, 2) of the underlying image: the maximum over the 8
    sub-positions, (B, n, n, n, 8C) -> (B, n, n, n, C)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaxPoolS2d.apply(x)
    return _max_pool_s2d_fwd(x)


@lru_cache(maxsize=None)
def _interp_pair(n_in: int, n_out_full: int) -> np.ndarray:
    """(2, n_out_full//2, n_in): even/odd rows of the align_corners
    interpolation matrix."""
    m = _interp_matrix(n_in, n_out_full)
    return np.stack([m[0::2], m[1::2]])


def upsample_to_s2d(x: torch.Tensor, scale: int, pair=None, space=None) -> torch.Tensor:
    """Trilinear align_corners upsample of (B, m, m, m, C) by `scale`,
    emitted in s2d layout (B, m*scale/2, ..., 8C). bf16 inputs contract
    in bf16 (one rounding per axis), f32 inputs in f32. `pair` is the
    precomputed (2, e*scale/2, e) even/odd matrix of the axes of extent e.
    `space` (a `parallel.DataMesh`): x is this rank's depth slab, the
    result its slab of the whole crop's upsample (`resize.slab_matrix`)."""
    ct = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    y = (x if space is None else halo(x, 1, 1, space)).to(ct)
    for axis in (1, 2, 3):
        ext = x.shape[axis]
        if axis == 1 and space is not None:
            m = torch.from_numpy(slab_matrix(ext, scale, space.space_size, space.space_rank))
        else:
            pr = pair if pair is not None and pair.shape[-1] == ext else \
                torch.from_numpy(_interp_pair(ext, ext * scale))
            # interleave the even/odd rows back into the full matrix
            m = pr.transpose(0, 1).reshape(-1, pr.shape[-1])
        y = contract_axis(m.to(device=x.device, dtype=ct), y, axis)
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
                    b_all: torch.Tensor | None, space=None) -> torch.Tensor:
    """The phased conv's ungathered output (B, n+1, n+1, n+1, 8Co) for a
    list of s2d tensors forming a plain concat: the concat never
    materializes (the conv is linear in its input channels, so the
    per-input partial convs sum). `space` (a `parallel.DataMesh`): the xs
    are this rank's depth slabs of nz planes, padded in depth by one halo
    plane a side, and the output is the (nz+1)-plane window grid
    (B, nz+1, n+1, n+1, 8Co) of the slab's phase windows."""
    y, off = None, 0
    for t in xs:
        k = t.shape[-1]
        yt = conv3d(t, w_all[:, :, :, off : off + k, :],
                    b_all if y is None else None, padding=1, space=space)
        y = yt if y is None else y + yt
        off += k
    return y


def phase_windows(y_ext: torch.Tensor) -> list:
    """The 8 phase windows y_ext[:, a:a+nz, b:b+n, c:c+n, qC:(q+1)C] of
    y_ext (B, nz+1, n+1, xw >= n+1, 8C) (nz = n: a cube; a depth slab's
    grid has nz + 1 planes)."""
    nz, n, co = y_ext.shape[1] - 1, y_ext.shape[2] - 1, y_ext.shape[-1] // 8
    return [
        y_ext[:, a : a + nz, bb : bb + n, c : c + n, q * co : (q + 1) * co]
        for q, (a, bb, c) in enumerate(product(range(2), repeat=3))
    ]
