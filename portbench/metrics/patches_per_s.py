"""Training crops stepped in the window (each step to its loss on the
host), per second of the window."""


def read(rec):
    if rec.kind != "train":
        return None
    return rec.work["crops"] / rec.window_s
