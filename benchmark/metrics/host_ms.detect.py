"""Host ms a call inside the port's calls (the blur and predict's enqueue), mean over the
profiler-off window's calls, by perf_counter."""

from benchmark.trace import host_ms


def read(rec):
    return host_ms(rec)
