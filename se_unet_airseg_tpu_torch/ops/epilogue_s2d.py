"""Fused epilogue of the s2d conv blocks: InstanceNorm affine, then
LeakyReLU(0.01), then 0, 1 or 2 spatial SE gates, in one pass.

Counterpart of the JAX package's `ops/pallas_s2d.py`. Its four Pallas
entry points on the inference path (`gated_norm_finalize[_bm]`,
`phased_finalize[_bm]`) are two CUDA kernels here
(`csrc/epilogue.cu`), built with nvcc for sm_90a at first use and
bound through ctypes:

  * `gathered_epilogue`: over an already-gathered s2d conv output
    (B, n, n, n, 8C);
  * `phased_epilogue`: over the phased conv's UNGATHERED output
    (B, n+1, n+1, xw, 8C); sub-position q = (a, b, c) of voxel
    (z, y, x) reads y_ext[z+a, y+b, x+c] in lane block q.

Each wrapper takes its plain PyTorch version (`*_plain`) for a CPU
tensor only; on a CUDA tensor it launches the kernel or raises. Each
counts its launches in `launch_counts`.

The block functions compute the InstanceNorm statistics in plain torch
(f32 sums, var = E[y^2] - mean^2 clamped at 0, scale = rsqrt(var+eps),
shift = mean*scale, e = y*scale - shift) and hand the affine to the
kernels:

  * `gated_norm_block(y, wse)`: gathered form (dense-lift, grouped
    dil-2 and CATConv blocks);
  * `phased_gated_block(xs, w_all, b_all, wse)`: phased conv (cuDNN,
    list partial sums), 8-phase-window statistics, phased form.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from .s2d import phase_windows, phased_conv_ext

F32 = torch.float32
_SRC = Path(__file__).resolve().parent.parent / "csrc" / "epilogue.cu"
_BUILD_DIR = _SRC.parent / "build"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launch_counts = {"gathered_epilogue": 0, "phased_epilogue": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ------------------------------------------------------------------ build


class _Library:
    """The compiled kernel library: built from `csrc/epilogue.cu` on
    first use into `csrc/build/` (named by the source's hash, so an
    edited source builds anew), then loaded with ctypes."""

    def __init__(self):
        self.lib = None
        self.path = None
        self.build_seconds = 0.0
        self.build_log = ""

    def load(self):
        if self.lib is not None:
            return self.lib
        src = _SRC.read_bytes()
        tag = hashlib.sha256(src).hexdigest()[:12]
        path = _BUILD_DIR / f"libairseg_epilogue_{tag}.so"
        t0 = time.perf_counter()
        if not path.exists():
            self.build_log = _nvcc(_SRC, path)
        self.build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.airseg_gathered_epilogue.argtypes = [i, p, p, p, p, p, i, ll, i, i, p]
        lib.airseg_gathered_epilogue.restype = i
        lib.airseg_phased_epilogue.argtypes = [i, p, ll, ll, ll, ll, p, p, p, p, i,
                                               ll, i, i, p]
        lib.airseg_phased_epilogue.restype = i
        self.lib, self.path = lib, path
        return lib


def _nvcc(src: Path, out: Path) -> str:
    """Compile `src` into the shared library `out`; returns nvcc's
    output (ptxas register and spill report included)."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = str(Path(cuda_home) / "bin" / "nvcc")
    out.parent.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent build
    # never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(src)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return res.stdout + res.stderr


_library = _Library()


def build_kernels() -> _Library:
    """Build (if needed) and load the kernels; returns the library
    record with `path`, `build_seconds` and `build_log`."""
    _library.load()
    return _library


# ----------------------------------------------------------- plain versions


def gathered_epilogue_plain(y, scale8, shift8, wse=None):
    """Plain PyTorch version of the gathered epilogue, with the kernel's
    rounding points. y (B, n, n, n, 8C); scale8/shift8 (B, 8C) f32;
    wse (G, C) in y's dtype or None."""
    dt = y.dtype
    bshape = (y.shape[0], 1, 1, 1, y.shape[-1])
    e = y.to(F32) * scale8.reshape(bshape) - shift8.reshape(bshape)
    e = torch.where(e >= 0, e, 0.01 * e).to(dt)
    if wse is not None:
        c = y.shape[-1] // 8
        for g in range(wse.shape[0]):
            ep = e.unflatten(-1, (8, c))
            logit = (ep.to(F32) * wse[g].to(F32)).sum(-1)
            gate = torch.sigmoid(logit).to(dt)
            e = (ep * gate.unsqueeze(-1)).flatten(-2)
    return e


def phased_epilogue_plain(y_ext, scale8, shift8, wse=None):
    """Plain PyTorch version of the phased epilogue: gather the 8 phase
    windows of y_ext (B, n+1, n+1, xw, 8C), then the gathered epilogue."""
    n = y_ext.shape[1] - 1
    y = torch.cat(phase_windows(y_ext, n), dim=-1)
    return gathered_epilogue_plain(y, scale8, shift8, wse)


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
    if y.data_ptr() % 16:
        raise ValueError("input must be 16-byte aligned")
    return vec


def _launch(fn, name, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    launch_counts[name] += 1


def gathered_epilogue(y, scale8, shift8, wse=None):
    """Gathered epilogue: y (B, n, n, n, 8C) contiguous -> same shape.
    Replaces gated_norm_finalize_bm / gated_norm_finalize."""
    if y.device.type == "cpu":
        return gathered_epilogue_plain(y, scale8, shift8, wse)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    b, n, c8 = y.shape[0], y.shape[1], y.shape[-1]
    if y.dim() != 5 or y.shape[1:4] != (n, n, n) or not y.is_contiguous():
        raise ValueError(f"y must be a contiguous (B, n, n, n, 8C) tensor, got "
                         f"{tuple(y.shape)}")
    _check_common(y, scale8, shift8, wse, c8)
    lib = _library.load()
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        _launch(lib.airseg_gathered_epilogue, "gathered_epilogue",
                _DTYPE_CODE[y.dtype], y.data_ptr(), out.data_ptr(), scale8.data_ptr(),
                shift8.data_ptr(), None if wse is None else wse.data_ptr(),
                0 if wse is None else wse.shape[0], b, n, c8, stream)
    return out


def phased_epilogue(y_ext, scale8, shift8, wse=None):
    """Phased epilogue: y_ext (B, n+1, n+1, xw, 8C), xw >= n+1, any
    16-byte-aligned strides with a unit channel stride -> gathered
    (B, n, n, n, 8C). Replaces phased_finalize_bm / phased_finalize."""
    if y_ext.device.type == "cpu":
        return phased_epilogue_plain(y_ext, scale8, shift8, wse)
    if y_ext.device.type != "cuda":
        raise ValueError(f"unsupported device {y_ext.device}")
    b, m, c8 = y_ext.shape[0], y_ext.shape[1], y_ext.shape[-1]
    n = m - 1
    if y_ext.dim() != 5 or y_ext.shape[2] != m or y_ext.shape[3] < m \
            or y_ext.stride(4) != 1:
        raise ValueError(f"y_ext must be (B, n+1, n+1, xw>=n+1, 8C) with unit "
                         f"channel stride, got {tuple(y_ext.shape)}")
    vec = _check_common(y_ext, scale8, shift8, wse, c8)
    sb, sz, sy, sx = (y_ext.stride(i) for i in range(4))
    if any(s % vec for s in (sb, sz, sy, sx)):
        raise ValueError("y_ext strides must be multiples of 16 bytes")
    lib = _library.load()
    out = torch.empty((b, n, n, n, c8), dtype=y_ext.dtype, device=y_ext.device)
    with torch.cuda.device(y_ext.device):
        stream = torch.cuda.current_stream(y_ext.device).cuda_stream
        _launch(lib.airseg_phased_epilogue, "phased_epilogue",
                _DTYPE_CODE[y_ext.dtype], y_ext.data_ptr(), sb, sz, sy, sx,
                out.data_ptr(), scale8.data_ptr(), shift8.data_ptr(),
                None if wse is None else wse.data_ptr(),
                0 if wse is None else wse.shape[0], b, n, c8, stream)
    return out


# ------------------------------------------------------------ block functions


def _affine8(s1, s2, nvox: int, eps: float):
    """(B, C) f32 sums -> the phase-tiled (B, 8C) scale8 and shift8."""
    mean = s1 / nvox
    var = torch.clamp(s2 / nvox - torch.square(mean), min=0.0)
    scale = torch.rsqrt(var + eps)
    return scale.repeat(1, 8).contiguous(), (mean * scale).repeat(1, 8).contiguous()


def gated_norm_block(y, wse=None, eps: float = 1e-5):
    """InstanceNorm (per original channel, over space x 8 sub-positions)
    + LeakyReLU + SE gate(s) of a gathered s2d conv output."""
    y = y.contiguous()
    b, c8 = y.shape[0], y.shape[-1]
    c = c8 // 8
    yf = y.to(F32)
    s1 = yf.sum(dim=(1, 2, 3)).reshape(b, 8, c).sum(1)
    s2 = torch.square(yf).sum(dim=(1, 2, 3)).reshape(b, 8, c).sum(1)
    del yf
    nvox = y.shape[1] * y.shape[2] * y.shape[3] * 8
    scale8, shift8 = _affine8(s1, s2, nvox, eps)
    return gathered_epilogue(y, scale8, shift8, wse)


def phased_gated_block(xs, w_all, b_all, wse=None, eps: float = 1e-5):
    """Phased s2d conv block: conv of the plain concat `xs` with the
    phase-stacked kernel (list partial sums, padding 1), statistics over
    the 8 phase windows of the ungathered output, then the phased
    epilogue."""
    xs = list(xs)
    n = xs[0].shape[1]
    y = phased_conv_ext(xs, w_all, b_all).contiguous()
    s1 = s2 = 0.0
    for sl in phase_windows(y, n):
        slf = sl.to(F32)
        s1 = s1 + slf.sum(dim=(1, 2, 3))
        s2 = s2 + torch.square(slf).sum(dim=(1, 2, 3))
    del slf
    scale8, shift8 = _affine8(s1, s2, 8 * n * n * n, eps)
    return phased_epilogue(y, scale8, shift8, wse)
