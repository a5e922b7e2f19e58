"""Device ms a step of the ops launched inside the port's ``nms`` spans
(``ops/nms.py``: sort, gather, both kernels and the selection of the RPN's
proposals)."""

from benchmark.trace import range_ms


def read(rec):
    return range_ms(rec, "nms")
