"""Producer milliseconds a batch spends cutting, flipping and rotating its
crops (`data.augment`), over the batches the profiled slice's record holds
whole."""

from portbench.program_trace import per_batch_ms


def read(rec):
    return per_batch_ms(rec, "data.augment")
