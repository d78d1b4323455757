"""Producer milliseconds a batch spends reading its case (`data.read`: the
gzip NIfTI CT and mask and the LIB weight, read and decompressed), over the
batches the profiled slice's record holds whole."""

from portbench.program_trace import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "data.read")
