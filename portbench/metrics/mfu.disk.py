"""The window's model operations (forward and backward of every conv per
crop stepped) over the window's seconds at the bf16 peak of
989 TFLOP/s, in percent."""

from portbench.metrics._shares import mfu


def read(rec):
    return mfu(rec, "train")
