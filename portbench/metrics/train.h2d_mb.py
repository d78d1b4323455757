"""Megabytes a step of the profiled slice uploads (the program's counter
`train.h2d_bytes` over the slice's steps, / 1e6)."""

from portbench.program_trace import counter_per_step


def read(rec):
    n = counter_per_step(rec, "train.h2d_bytes")
    return n / 1e6 if n is not None else None
