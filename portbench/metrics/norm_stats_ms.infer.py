"""Device milliseconds a tile batch of the profiled slice spends in the work
launched under the program's norm-statistics spans (`norm.stats`: the
InstanceNorm sums and affine in plain torch)."""

from portbench.program_trace import device_ms_under


def read(rec):
    return device_ms_under(rec, "norm.", "infer")
