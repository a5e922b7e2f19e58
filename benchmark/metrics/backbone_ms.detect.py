"""Device ms a call of the ops launched inside the port's ``predict.backbone`` range
(the backbone and FPN)."""

from benchmark.trace import range_ms


def read(rec):
    return range_ms(rec, "predict.backbone")
