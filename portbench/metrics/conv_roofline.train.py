"""The 3x3x3 convs' least time (operations at 989 TFLOP/s against bytes
once at 3.35 TB/s, conv by conv, counted from the published layers; the
forward, weight gradient and input gradient, not remat's recompute) over
the device time of every conv kernel in the profiled slice (whatever an
aten convolution op or its backward launched, and K8-K11), in percent."""

from portbench.metrics._shares import conv_roofline


def read(rec):
    return conv_roofline(rec, "train")
