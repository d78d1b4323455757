"""Training crops stepped in the window, each step to its loss on the host,
per second of the window, where each batch comes from the data layer's
files (the epoch pass's feed sets the pace): the same quantity as
`patches_per_s`, under its own name and bound because the host pipeline
spreads far more from run to run than the step does."""


def read(rec):
    if rec.kind != "train":
        return None
    return rec.work["crops"] / rec.window_s
