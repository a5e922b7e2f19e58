"""Device ms a call of the ops launched inside the port's ``norm`` spans
(``FrozenBatchNorm``, one a norm call of the backbone)."""

from benchmark.trace import range_ms


def read(rec):
    return range_ms(rec, "norm")
