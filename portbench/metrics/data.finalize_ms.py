"""Producer milliseconds a batch spends windowing its crops, raising the LIB
weight to its power and stacking the batch (`data.finalize`), over the
batches the profiled slice's record holds whole."""

from portbench.program_trace import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "data.finalize")
