"""Device ms a step of the ops launched inside the port's ``norm`` spans
(``FrozenBatchNorm`` and ``AdaptiveBatchNorm``, one a norm call): the
forward's norms only, since the backward runs on another thread."""

from benchmark.trace import range_ms


def read(rec):
    return range_ms(rec, "norm")
