"""RoIAlign forward's share of its roofline in the train step: the bound of the
bytes and FLOPs the reference counts from its sampled rois over the device time
of the kernels named in ``KERNELS``, a step."""

from benchmark.trace import kernel_ms, roofline_pct

KERNELS = ("roi_align_fwd_kernel",)


def read(rec):
    return roofline_pct(rec, "roi_fwd", kernel_ms(rec, KERNELS))
