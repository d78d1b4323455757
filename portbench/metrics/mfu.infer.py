"""The window's model operations (every conv's forward per tile of the volumes
completed, padding tiles left out) over the window's seconds at the bf16 peak of
989 TFLOP/s, in percent."""

from portbench.metrics._shares import mfu


def read(rec):
    return mfu(rec, "infer")
