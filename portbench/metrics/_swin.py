"""Arithmetic of the Swin UNETR cell's shares: each reads the profiled slice
(or the window) of an inference run that recorded its model's settings, and
returns a percentage, or None where there is nothing to read."""

from portbench import counts, counts_swinunetr

K7_KERNELS = ("ring_kernel", "reg_kernel")  # csrc/norm_leaky.cu, both forms


def _model(rec):
    return rec.work.get("model") if rec.kind == "infer" else None


def _batches(rec) -> float:
    return rec.slice_work["tiles_run"] / rec.batch


def _share(least_s: float, dev_s: float):
    return 100.0 * least_s / dev_s if dev_s > 0 and least_s > 0 else None


def attn_roofline(rec):
    conf = _model(rec)
    if conf is None or rec.trace is None:
        return None
    dev_s = rec.trace.launched_under_s(lambda n: n.startswith("swin.attn"))
    return _share(counts_swinunetr.attn_least_s(conf, rec.crop, rec.batch) * _batches(rec),
                  dev_s)


def conv_roofline(rec):
    conf = _model(rec)
    if conf is None or rec.trace is None:
        return None
    return _share(counts_swinunetr.conv_least_s(conf, rec.crop, rec.batch) * _batches(rec),
                  rec.trace.conv_s())


def norm_leaky_roofline(rec):
    conf = _model(rec)
    if conf is None or rec.trace is None:
        return None
    launches = rec.slice_work["launches"].get("instance_norm_leaky_fwd", 0)
    nbytes = (launches / counts_swinunetr.K7_LAUNCHES
              * counts_swinunetr.norm_leaky_bytes(conf, rec.crop, rec.batch))
    return _share(nbytes / counts.HBM_BYTES_PER_S, rec.trace.kernel_s(K7_KERNELS))


def mfu(rec):
    conf = _model(rec)
    if conf is None:
        return None
    flops = rec.work["tiles"] * counts_swinunetr.forward_flops(conf, rec.crop)
    return 100.0 * flops / rec.window_s / counts.BF16_FLOPS
