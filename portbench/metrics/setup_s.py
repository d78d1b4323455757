"""Set-up seconds: from the process's start to the window's (loading,
building the kernels in a first run, inputs, weights, warm-up)."""


def read(rec):
    return rec.setup_s
