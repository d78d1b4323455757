"""se_unet_airseg_tpu_torch — the SE-UNet airway-segmentation inference
path in PyTorch, for one NVIDIA Hopper GPU (H100, sm_90a).

A port of the eval-mode whole-volume inference path of the JAX package
`se_unet_airseg_tpu`, which stays the reference. Module names mirror
that package so each function's counterpart is easy to find. Public
functions keep its channels-last NDHWC layout; convolution weights in
the parameter tree are DHWIO, the module's own parameters OIDHW (the
reference `.pth` layout).

The fused conv epilogue (InstanceNorm affine + LeakyReLU + SE gates),
which the JAX package runs as Pallas TPU kernels, runs here as two
hand-written CUDA kernels (`csrc/epilogue.cu`, wrappers in
`ops/epilogue_s2d.py`). Entry points run on `cuda` unless the caller
passes `device="cpu"`; on CPU tensors the kernel wrappers take their
plain PyTorch versions.
"""

__version__ = "0.1.0"
