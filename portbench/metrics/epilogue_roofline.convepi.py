"""The fused epilogues' bytes once (K1/K2, counted
from their launch counters and the layer shapes) at 3.35 TB/s over their
device time in the profiled slice, in percent."""

from portbench.metrics._shares import epilogue_roofline


def read(rec):
    return epilogue_roofline(rec, "infer")
