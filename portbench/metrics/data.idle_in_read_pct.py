"""The share of the profiled slice's device-idle time during which the
Prefetcher's thread was reading a case (`data.read`), in percent."""

from portbench.program_trace import idle_share_in


def read(rec):
    return idle_share_in(rec, "data.read")
