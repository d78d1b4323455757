"""Input CT voxels of the volumes completed in the window, per second of
the window, in millions: voxels and not tiles, so a change of tiling
cannot move it."""


def read(rec):
    if rec.kind != "infer":
        return None
    return rec.work["voxels"] / rec.window_s / 1e6
