"""Device ms a step of the ops launched inside the port's ``train.optimizer``
span (the learning rate's set and SGD's step)."""

from benchmark.trace import range_ms


def read(rec):
    return range_ms(rec, "train.optimizer")
