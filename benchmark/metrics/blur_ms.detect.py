"""Device ms a call of the ops launched inside the harness's ``bench.blur`` span
(``ops/blur.py::batched_blur``)."""

from benchmark.trace import range_ms


def read(rec):
    return range_ms(rec, "bench.blur")
