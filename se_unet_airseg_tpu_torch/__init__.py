"""se_unet_airseg_tpu_torch — SE-UNet airway segmentation in PyTorch,
for one NVIDIA Hopper GPU (H100, sm_90a).

A port of the JAX package `se_unet_airseg_tpu`, which stays the
reference: the model and its fast path, the whole-volume runner (eval
and train mode), the train step, the inference drivers (`validate`,
`run_test`, `network_prediction`), the predict and test CLIs, and their
host code (NIfTI I/O, preprocessing, post-processing, metrics, LOG
book, checkpoints). Module names mirror that package so each function's
counterpart is easy to find. Public
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
