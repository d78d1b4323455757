"""The window attention's least time (QK^T and PV over the padded windows at
989 TFLOP/s against q, k, v, the output and the bias and shift mask read
once at 3.35 TB/s, block by block; `counts_swinunetr.attn_least_s`) over
the device time launched under the program's `swin.attn` spans, in
percent."""

from portbench.metrics._swin import attn_roofline


def read(rec):
    return attn_roofline(rec)
