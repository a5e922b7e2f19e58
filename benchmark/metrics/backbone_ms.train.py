"""Device ms a step of the ops launched inside the port's ``loss.backbone``
span (the backbone and FPN of the train forward)."""

from benchmark.trace import range_ms


def read(rec):
    return range_ms(rec, "loss.backbone")
