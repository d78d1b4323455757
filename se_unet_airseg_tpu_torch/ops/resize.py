"""Trilinear upsampling with PyTorch `align_corners=True` semantics,
written as one dense (out, in) interpolation matrix per axis so the
NDHWC layout needs no relayout (three small matrix contractions).

On a depth slab of the mesh's `space` axis (`space=`), the depth axis
takes this slab's rows of the whole crop's matrix (`slab_matrix`) on the
slab with one halo plane each side (`parallel.halo`)."""

from functools import lru_cache

import numpy as np
import torch

from ..parallel.mesh import halo


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


@lru_cache(maxsize=None)
def slab_matrix(nz: int, scale: int, n_space: int, s: int) -> np.ndarray:
    """(nz*scale, nz+2): the rows [s nz scale, (s+1) nz scale) of the
    whole crop's matrix `_interp_matrix(nz n_space, nz n_space scale)`,
    on the planes s nz - 1 .. (s+1) nz, slab s of nz planes with one halo
    plane each side (a plane outside the crop gets no weight). Raises if
    a row has weight outside that window: an output near a slab's end
    samples the neighbour's boundary plane (n = 16, two slabs: output 15
    samples input 7.26, which reads plane 8 of the next slab), never
    further."""
    n = nz * n_space
    rows = np.pad(_interp_matrix(n, n * scale), ((0, 0), (1, 1)))[s * nz * scale:
                                                                  (s + 1) * nz * scale]
    local = rows[:, s * nz:s * nz + nz + 2]
    if np.count_nonzero(local) != np.count_nonzero(rows):
        raise RuntimeError(f"slab {s} of {n_space} ({nz} planes, scale {scale}) samples "
                           f"beyond its halo")
    return local


def contract_axis(m: torch.Tensor, y: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply the (out, in) matrix `m` along `axis` of `y`."""
    return torch.movedim(torch.tensordot(m, y, dims=([1], [axis])), 0, axis)


def upsample_trilinear(x: torch.Tensor, scale: int, mat=None, space=None) -> torch.Tensor:
    """Trilinear upsample of an NDHWC tensor by an integer factor, in
    float32; `mat` is a precomputed (e*scale, e) matrix of the axes of
    extent e. `space` (a `parallel.DataMesh`): x is this rank's depth
    slab, the result its slab of the whole crop's upsample."""
    if scale == 1:
        return x
    y = x.to(torch.float32) if space is None else halo(x, 1, 1, space).to(torch.float32)
    for axis in (1, 2, 3):
        ext = x.shape[axis]
        if axis == 1 and space is not None:
            m = torch.from_numpy(slab_matrix(ext, scale, space.space_size, space.space_rank))
        elif mat is not None and mat.shape[-1] == ext:
            m = mat
        else:
            m = torch.from_numpy(_interp_matrix(ext, ext * scale))
        y = contract_axis(m.to(device=x.device, dtype=torch.float32), y, axis)
    return y.to(x.dtype).contiguous()
