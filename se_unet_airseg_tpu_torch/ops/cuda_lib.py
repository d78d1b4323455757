"""Build, load and count the port's hand-written CUDA kernels.

The sources under `csrc/` are compiled for sm_90a, one nvcc per source,
all started together, and linked into one shared library under the
git-ignored `csrc/build/`, named by the sources' hash (an edited source
builds anew), at first use, and loaded with ctypes.

`launch_counts` holds one count per kernel; a wrapper adds one where it
launches its kernel and nowhere else. The helpers below are the wrappers'
shared rules: which tensors go to a kernel, in which type code, and the
accumulation type of the plain versions.
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

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = _CSRC / "build"
_SOURCES = ("epilogue.cu", "pool_s2d.cu", "conv_stats.cu", "norm_leaky.cu", "conv_wgmma.cu",
            "dil2_wgmma.cu", "norm_stats.cu")

launch_counts = {"gathered_epilogue": 0, "phased_epilogue": 0,
                 "phased_normalize": 0, "max_pool_s2d_bwd": 0,
                 "phased_conv_stats": 0, "dil2_conv_stats": 0,
                 "dil2_dense_conv_stats": 0, "phased_conv_ungathered": 0,
                 "instance_norm_leaky_fwd": 0, "instance_norm_leaky_bwd": 0,
                 "norm_stats": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


F32 = torch.float32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype argument


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Accumulation type: float32, or float64 for float64 inputs."""
    return torch.float64 if dtype == torch.float64 else F32


def _on_card(t) -> bool:
    """False for a CPU tensor (the caller takes the plain version); True
    for a CUDA tensor; raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# exported C functions: name -> argument types (all return int)
_SIGNATURES = {
    "airseg_gathered_epilogue": [_I, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _P],
    "airseg_phased_epilogue": [_I, _I, _P, _LL, _LL, _LL, _LL, _I, _P, _P, _P, _P, _I,
                               _LL, _I, _I, _I, _P],
    "airseg_epilogue_tma_smem": [_I, _I],
    "airseg_phased_normalize": [_I, _I, _P, _LL, _LL, _LL, _LL, _I, _P, _P, _P, _LL, _I,
                                _I, _I, _P],
    "airseg_max_pool_s2d_bwd": [_I, _P, _P, _P, _LL, _I, _I, _P],
    "airseg_phased_conv_stats": [_I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
    "airseg_conv_wgmma": [_I, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P, _LL, _I, _I,
                          _I, _P],
    "airseg_conv_wgmma_smem": [_I],
    "airseg_dil2_conv_stats": [_I, _P, _I, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
    "airseg_dil2_wgmma": [_P, _I, _P, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P],
    "airseg_dil2_wgmma_smem": [_I, _I, _I, _I],
    "airseg_dil2_dense_conv_stats": [_I, _P, _I, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
    "airseg_phased_conv_ext": [_I, _P, _I, _P, _I, _P, _P, _P, _LL, _I, _I, _P],
    "airseg_norm_leaky_fwd": [_I, _P, _P, _P, _P, _LL, _LL, _I, _P],
    "airseg_norm_leaky_ring_smem": [],
    "airseg_norm_leaky_bwd": [_I, _P, _P, _P, _P, _P, _LL, _LL, _I, _P],
    "airseg_norm_stats_gathered": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "airseg_norm_stats_phased": [_I, _P, _LL, _LL, _LL, _LL, _P, _P, _I, _I, _I, _I, _I, _P],
}


class _Library:
    """The compiled kernels: built on first use, then loaded with ctypes."""

    def __init__(self):
        self.lib = None
        self.path = None
        self.build_seconds = 0.0
        self.build_log = ""

    def load(self):
        if self.lib is not None:
            return self.lib
        sources = [_CSRC / s for s in _SOURCES]
        tag = hashlib.sha256(b"".join(s.read_bytes() for s in sources)).hexdigest()[:12]
        path = _BUILD_DIR / f"libairseg_kernels_{tag}.so"
        t0 = time.perf_counter()
        if not path.exists():
            self.build_log = _nvcc(sources, path)
        self.build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
        self.lib, self.path = lib, path
        return lib


def _nvcc(sources: list[Path], out: Path) -> str:
    """Compile each of `sources` to an object, one nvcc per source, all
    started together, and link them into the shared library `out`;
    returns nvcc's output (ptxas register and spill report included)."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = str(Path(cuda_home) / "bin" / "nvcc")
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    out.parent.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory, then rename: a concurrent build
    # never loads a half-written library
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen([nvcc, *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                                   "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
        so = Path(tmp) / out.name
        res = subprocess.run([nvcc, *arch, "-shared", "-o", str(so), *map(str, objs)],
                             capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(so, out)
    return "".join(logs) + res.stdout + res.stderr


library = _Library()


def build_kernels() -> _Library:
    """Build (if needed) and load the kernel library; returns it, with
    its `path`, `build_seconds` and `build_log`."""
    library.load()
    return library


def launch(fn_name: str, count_name: str, *args) -> None:
    """Call one exported launcher and count the launch; raises on a
    refused launch."""
    rc = getattr(library.load(), fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{count_name} kernel launch failed: cudaError {rc}")
    launch_counts[count_name] += 1
