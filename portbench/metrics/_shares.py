"""Arithmetic the share metrics have in common: each reads the profiled
slice of a run of its kind and returns a percentage, or None where the
slice has nothing to read (never 0 for a share of a peak or a roofline)."""

from portbench import counts
from portbench.trace import EPILOGUE_KERNELS

TRAIN_EPILOGUES = ("gathered_epilogue", "phased_epilogue", "phased_normalize")
INFER_EPILOGUES = ("gathered_epilogue", "phased_epilogue")


def _passes(rec) -> float:
    """Tile batches (inference) or steps (training) in the slice."""
    return (rec.slice_work["tiles_run"] / rec.batch if rec.kind == "infer"
            else rec.slice_work["steps"])


def conv_roofline(rec, kind):
    if rec.trace is None or rec.kind != kind:
        return None
    conv_s = rec.trace.conv_s()
    if conv_s <= 0:
        return None
    least = counts.conv3_least_s(rec.crop, rec.batch, train=kind == "train") * _passes(rec)
    return 100.0 * least / conv_s


def epilogue_roofline(rec, kind):
    if rec.trace is None or rec.kind != kind:
        return None
    dev_s = rec.trace.kernel_s(EPILOGUE_KERNELS)
    launches = rec.slice_work["launches"]
    nbytes = sum(launches[k] / len(counts.EPILOGUE_BLOCKS[k])
                 * counts.epilogue_bytes(k, rec.batch, rec.crop)
                 for k in (TRAIN_EPILOGUES if kind == "train" else INFER_EPILOGUES))
    if dev_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / counts.HBM_BYTES_PER_S / dev_s


def mfu(rec, kind):
    if rec.kind != kind:
        return None
    if kind == "infer":
        flops = rec.work["tiles"] * counts.forward_flops(rec.crop)
    else:
        flops = rec.work["crops"] * counts.train_flops(rec.crop)
    return 100.0 * flops / rec.window_s / counts.BF16_FLOPS


def device_idle(rec, kind):
    if rec.trace is None or rec.kind != kind:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
