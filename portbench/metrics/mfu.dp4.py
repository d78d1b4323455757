"""The window's model operations (forward and backward of every crop of the
global batches stepped) over the window's seconds at the bf16 peak of 989
TFLOP/s of each of the run's cards, in percent."""

from portbench import counts


def read(rec):
    if rec.kind != "train" or "ranks" not in rec.work:
        return None
    flops = rec.work["crops"] * counts.train_flops(rec.crop)
    return 100.0 * flops / rec.window_s / (counts.BF16_FLOPS * rec.work["ranks"])
