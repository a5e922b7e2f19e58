"""RoIAlign forward's share of its roofline: the bound of the bytes and FLOPs the
reference counts from its rois on the sampled batches (``reference/counts.py``)
over all device time under the port's ``predict.roi_align`` range, a call."""

from benchmark.trace import range_ms, roofline_pct


def read(rec):
    return roofline_pct(rec, "roi_fwd", range_ms(rec, "predict.roi_align"))
