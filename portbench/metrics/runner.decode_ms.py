"""Host milliseconds a volume of the profiled slice spends copying the
mixed trit chunks and unpacking them (`runner.decode`)."""

from portbench.program_trace import per_volume_ms


def read(rec):
    return per_volume_ms(rec, "runner.decode")
