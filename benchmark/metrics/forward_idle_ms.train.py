"""Device-idle ms a step in the gaps whose middle falls inside the port's
``train.forward`` span on the traced window's thread (host and device
profiled: the profiler slows the host, so this reads high)."""

from benchmark.spans import idle_ms


def read(rec):
    return idle_ms(rec, "train.forward")
