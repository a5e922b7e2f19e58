"""What the readers of the program's own spans share beyond ``trace.py``:
the device time of the ops launched outside every range of their thread
(the autograd engine's device thread, which runs the backward), and the
device's idle time while the traced window's thread was inside a span.

A span counts only where the trace holds it: a program without it reads
None, not zero.
"""

from __future__ import annotations

import bisect
from typing import Dict, Optional

from benchmark.trace import idle_gaps, union


def unranged_ms(rec: Dict, span: str) -> Optional[float]:
    """Device ms a call of the ops launched with no range open on their
    thread, or inside ``span``; None where the trace has no ``span``. In
    the harness's traced window every launch from the window's thread has
    ``bench.traced_window`` open, so an op with none came from another
    thread: on a card, the autograd engine's, which launches the backward
    that ``span`` wraps on the main thread."""
    if not rec["calls"] or not any(r.name == span for r in rec["ranges"]):
        return None
    ops = [o for o in rec["ops"] if not o.ranges or span in o.ranges]
    return sum(o.dur for o in ops) / 1e3 / rec["calls"]


def idle_ms(rec: Dict, span: str) -> Optional[float]:
    """Device-idle ms a call in the gaps of the traced window whose middle
    falls inside ``span`` on the window's thread ``rec["tid"]``; None
    where that thread has no ``span``."""
    spans = union((r.start, r.start + r.dur) for r in rec["ranges"]
                  if r.name == span and r.tid == rec["tid"])
    if not spans or not rec["calls"]:
        return None
    starts = [s for s, _ in spans]
    total = 0.0
    for s, e in idle_gaps(rec["ops"], rec["window_us"]):
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= spans[i][1]:
            total += e - s
    return total / 1e3 / rec["calls"]
