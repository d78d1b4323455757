"""Device ops of the port: plain PyTorch building blocks and the CUDA
kernels' wrappers (fused epilogue, phased normalize, pool backward, conv
+ statistics, the ungathered phased conv, InstanceNorm + LeakyReLU)."""

from .conv import conv3d, conv_transpose3d
from .conv_stats import (
    dil2_conv_stats,
    dil2_dense_conv_stats,
    phased_conv_stats,
    phased_conv_ungathered,
)
from .cuda_lib import build_kernels, launch_counts, reset_launch_counts
from .epilogue_s2d import (
    dil2_gated_block,
    gated_norm_block,
    gathered_epilogue,
    phased_epilogue,
    phased_gated_block,
    phased_normalize,
)
from .norm_leaky import instance_norm_leaky, instance_norm_leaky_ndhwc, instance_norm_leaky_s2d
from .norms import instance_norm, leaky_relu
from .pool import max_pool3d
from .resize import upsample_trilinear
from .s2d import max_pool_s2d, max_pool_s2d_bwd
from .windowing import hu_dual_window

__all__ = [
    "build_kernels",
    "conv3d",
    "conv_transpose3d",
    "dil2_conv_stats",
    "dil2_dense_conv_stats",
    "dil2_gated_block",
    "gated_norm_block",
    "gathered_epilogue",
    "hu_dual_window",
    "instance_norm",
    "instance_norm_leaky",
    "instance_norm_leaky_ndhwc",
    "instance_norm_leaky_s2d",
    "launch_counts",
    "leaky_relu",
    "max_pool3d",
    "max_pool_s2d",
    "max_pool_s2d_bwd",
    "phased_epilogue",
    "phased_conv_stats",
    "phased_conv_ungathered",
    "phased_gated_block",
    "phased_normalize",
    "reset_launch_counts",
    "upsample_trilinear",
]
