"""`mvox_per_s` of the conv_epi cell, under its own name and bound: its
runs spread three times as wide as the default configuration's (the host's
share of a volume is larger where the device is faster)."""


def read(rec):
    if rec.kind != "infer":
        return None
    return rec.work["voxels"] / rec.window_s / 1e6
