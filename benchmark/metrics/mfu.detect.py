"""The reference's FLOPs of a call (products and convolutions) over the time a call
of the profiler-off window and the card's dense bf16 peak."""

from benchmark.trace import mfu_pct


def read(rec):
    return mfu_pct(rec)
