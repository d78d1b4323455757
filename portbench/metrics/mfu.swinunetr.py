"""The window's model operations (every conv, every linear layer, the
attention products over the padded windows, per real tile of the volumes
completed) over the window's seconds at the bf16 peak of 989 TFLOP/s, in
percent."""

from portbench.metrics._swin import mfu


def read(rec):
    return mfu(rec)
