"""Device ms a step of the backward: the ops launched outside every range of
their thread (the autograd engine's device thread) or inside the port's
``train.backward`` span; None without that span."""

from benchmark.spans import unranged_ms


def read(rec):
    return unranged_ms(rec, "train.backward")
