"""Device ms a call of the ops launched inside the port's ``nms`` spans
(``ops/nms.py``: the RPN's grouped NMS and the postprocess's batched NMS)."""

from benchmark.trace import range_ms


def read(rec):
    return range_ms(rec, "nms")
