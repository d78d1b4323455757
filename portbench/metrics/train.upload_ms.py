"""Host milliseconds a step of the profiled slice spends uploading its
batch (`train.upload`: the pageable host-to-device copies)."""

from portbench.program_trace import per_step_ms


def read(rec):
    return per_step_ms(rec, "train.upload")
