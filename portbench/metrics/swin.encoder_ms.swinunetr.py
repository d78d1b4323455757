"""Device milliseconds a tile batch of the profiled slice spends in the work
launched under the program's `swin.stage` spans (each Swin stage's blocks
and its patch merging)."""

from portbench.program_trace import device_ms_under


def read(rec):
    return device_ms_under(rec, "swin.stage", "infer")
