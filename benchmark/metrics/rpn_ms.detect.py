"""Device ms a call of the ops launched inside the port's ``predict.rpn`` range
(the RPN head, top-k and NMS)."""

from benchmark.trace import range_ms


def read(rec):
    return range_ms(rec, "predict.rpn")
