"""Every conv's least time in Swin UNETR (patch embedding, the res blocks'
3x3x3 and 1x1x1 convs, the transposed convs, the logits; operations at 989
TFLOP/s against bytes once at 3.35 TB/s, conv by conv) over the device time
of whatever an aten convolution op launched in the profiled slice, in
percent."""

from portbench.metrics._swin import conv_roofline


def read(rec):
    return conv_roofline(rec)
