"""The share of the profiled slice in which no kernel, copy or memset ran
on the device, in percent."""

from portbench.metrics._shares import device_idle


def read(rec):
    return device_idle(rec, "infer")
