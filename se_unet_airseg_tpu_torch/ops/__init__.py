"""Device ops of the port: plain PyTorch building blocks and the fused
epilogue kernels' wrappers."""

from .conv import conv3d
from .epilogue_s2d import (
    gated_norm_block,
    gathered_epilogue,
    launch_counts,
    phased_epilogue,
    phased_gated_block,
    reset_launch_counts,
)
from .norms import instance_norm, leaky_relu
from .pool import max_pool3d
from .resize import upsample_trilinear
from .windowing import hu_dual_window

__all__ = [
    "conv3d",
    "gated_norm_block",
    "gathered_epilogue",
    "hu_dual_window",
    "instance_norm",
    "launch_counts",
    "leaky_relu",
    "max_pool3d",
    "phased_epilogue",
    "phased_gated_block",
    "reset_launch_counts",
    "upsample_trilinear",
]
