from .devices import device_summary, pick_devices, resolve_device
from .profiling import Timer, device_trace, time_report

__all__ = ["Timer", "device_summary", "device_trace", "pick_devices", "resolve_device",
           "time_report"]
