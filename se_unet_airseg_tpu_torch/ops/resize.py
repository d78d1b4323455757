"""Trilinear upsampling with PyTorch `align_corners=True` semantics,
written as one dense (out, in) interpolation matrix per axis so the
NDHWC layout needs no relayout (three small matrix contractions)."""

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense 1-D linear-interpolation matrix, align_corners=True: output
    i samples input i*(n_in-1)/(n_out-1); at most two non-zeros a row."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1 or n_out == 1:
        m[:, 0] = 1.0
        return m
    scale = (n_in - 1) / (n_out - 1)
    src = np.arange(n_out, dtype=np.float64) * scale
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    frac = (src - lo).astype(np.float32)
    rows = np.arange(n_out)
    m[rows, lo] = 1.0 - frac
    m[rows, lo + 1] = frac
    return m


def contract_axis(m: torch.Tensor, y: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply the (out, in) matrix `m` along `axis` of `y`."""
    return torch.movedim(torch.tensordot(m, y, dims=([1], [axis])), 0, axis)


def upsample_trilinear(x: torch.Tensor, scale: int, mat=None) -> torch.Tensor:
    """Trilinear upsample of an NDHWC tensor by an integer factor, in
    float32; `mat` is a precomputed (d*scale, d) matrix for cubes."""
    if scale == 1:
        return x
    _, d, h, w, _ = x.shape
    mats = []
    for ext in (d, h, w):
        if mat is not None:
            mats.append(mat.to(device=x.device, dtype=torch.float32))
        else:
            mats.append(torch.from_numpy(_interp_matrix(ext, ext * scale)).to(x.device))
    y = x.to(torch.float32)
    for axis, m in zip((1, 2, 3), mats):
        y = contract_axis(m, y, axis)
    return y.to(x.dtype).contiguous()
