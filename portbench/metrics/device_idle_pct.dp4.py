"""The share of rank 0's profiled slice in which no kernel, copy or memset
ran on its card, in percent."""

from portbench.metrics._shares import device_idle


def read(rec):
    return device_idle(rec, "train")
