"""RoIAlign backward's share of its roofline: the bound of the cotangent read once
and every cell an active roi touches read and written once in float32, counted
from the reference's sampled rois, over the device time of the kernels named in
``KERNELS``, a step (the zero-fill and the cast are other kernels)."""

from benchmark.trace import kernel_ms, roofline_pct

KERNELS = ("roi_align_bwd_kernel",)


def read(rec):
    return roofline_pct(rec, "roi_bwd", kernel_ms(rec, KERNELS))
