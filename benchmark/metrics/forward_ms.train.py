"""Device ms a step of the ops launched inside the port's ``train.forward``
span (``train/engine.py::make_train_step``: the loss call and the sum of the
losses)."""

from benchmark.trace import range_ms


def read(rec):
    return range_ms(rec, "train.forward")
