"""Device milliseconds a step spends in work launched by the autograd
engine's nodes (the backward, remat's recomputed forwards included), from
the profiled slice."""


def read(rec):
    if rec.trace is None or rec.kind != "train":
        return None
    return 1e3 * rec.trace.backward_s() / rec.slice_work["steps"]
