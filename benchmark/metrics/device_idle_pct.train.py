"""Share of the traced window in which no device op ran (the union of their
intervals)."""

from benchmark.trace import idle_pct


def read(rec):
    return idle_pct(rec)
