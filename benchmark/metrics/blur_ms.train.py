"""Device ms a step of the ops launched inside the port's ``blur`` span
(``ops/blur.py::batched_blur``, the train step's device blur)."""

from benchmark.trace import range_ms


def read(rec):
    return range_ms(rec, "blur")
