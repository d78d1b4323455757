"""K7's bytes once (each res block's first InstanceNorm + LeakyReLU: its
input read and its output written, counted from the launch counter and the
layer shapes) at 3.35 TB/s over K7's device time in the profiled slice, in
percent."""

from portbench.metrics._swin import norm_leaky_roofline


def read(rec):
    return norm_leaky_roofline(rec)
