"""The reference's FLOPs of a step (forward, losses' inputs, backward of what
trains) over the time a step of the profiler-off window and the card's dense
bf16 peak."""

from benchmark.trace import mfu_pct


def read(rec):
    return mfu_pct(rec)
