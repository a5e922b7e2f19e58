"""Host ms a step inside the train step's call, mean over the profiler-off window's
steps, by perf_counter."""

from benchmark.trace import host_ms


def read(rec):
    return host_ms(rec)
