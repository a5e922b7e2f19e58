"""Device ms a call of the ops launched inside the port's ``predict.head_postprocess``
range (the box head, postprocess and its batched NMS)."""

from benchmark.trace import range_ms


def read(rec):
    return range_ms(rec, "predict.head_postprocess")
