"""Host milliseconds a volume of the profiled slice spends padding, casting
and uploading the volume (`runner.prep`)."""

from portbench.program_trace import per_volume_ms


def read(rec):
    return per_volume_ms(rec, "runner.prep")
