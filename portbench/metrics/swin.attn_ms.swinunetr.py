"""Device milliseconds a tile batch of the profiled slice spends in the work
launched under the program's `swin.attn` spans (each window attention's
core: q, k, v to the heads' outputs, with the relative-position bias and
the shift mask)."""

from portbench.program_trace import device_ms_under


def read(rec):
    return device_ms_under(rec, "swin.attn", "infer")
