"""Device milliseconds a step of the profiled slice spends in the work
launched under the program's norm-statistics spans (`norm.stats` in the
forward and in remat's and the backward's recomputes, `norm.bwd_stats`: the
backward's sums)."""

from portbench.program_trace import device_ms_under


def read(rec):
    return device_ms_under(rec, "norm.", "train")
