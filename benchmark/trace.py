"""Reading a traced segment: the device's operations from a
``torch.profiler`` Chrome trace, each tied to the host ranges that were
open when it was launched, and the arithmetic the per-layer metrics share
(device time under a range or by kernel name, the union of busy
intervals, idle gaps).

A device operation (kernel, copy, memset) is joined to its launch on the
host by the profiler's correlation id; the launch's thread and time give
the ``record_function`` ranges around it. Times are microseconds, as the
trace has them.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class DeviceOp(NamedTuple):
    name: str
    start: float
    dur: float
    ranges: frozenset     # names of the host ranges open at its launch


class Range(NamedTuple):
    name: str
    start: float
    dur: float
    tid: object


def parse(events: Sequence[dict]) -> Tuple[List[DeviceOp], List[Range],
                                           List[Range]]:
    """(device ops, ``record_function`` ranges, host operators) of a
    Chrome trace's ``traceEvents``."""
    launches, ranges, cpu_ops, dev = {}, [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (float(e["ts"]), e.get("tid"))
        elif cat == "user_annotation":
            ranges.append(Range(e["name"], float(e["ts"]), float(e["dur"]),
                                e.get("tid")))
        elif cat == "cpu_op":
            cpu_ops.append(Range(e["name"], float(e["ts"]), float(e["dur"]),
                                 e.get("tid")))
        elif cat in DEVICE_CATS:
            dev.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
                        corr))
    by_tid = defaultdict(list)
    for r in ranges:
        by_tid[r.tid].append(r)
    ops = []
    for name, ts, dur, corr in dev:
        open_ = frozenset()
        if corr in launches:
            t, tid = launches[corr]
            open_ = frozenset(r.name for r in by_tid.get(tid, ())
                              if r.start <= t <= r.start + r.dur)
        ops.append(DeviceOp(name, ts, dur, open_))
    ops.sort(key=lambda o: o.start)
    return ops, ranges, cpu_ops


def load(path: str):
    with open(path) as f:
        return parse(json.load(f)["traceEvents"])


def union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    """Merged [start, end] intervals of (start, end) pairs."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(ops: Sequence[DeviceOp], window: Tuple[float, float]) -> float:
    """Length of the union of the device ops' intervals inside
    ``window``."""
    lo, hi = window
    merged = union((max(o.start, lo), min(o.start + o.dur, hi))
                   for o in ops if o.start < hi and o.start + o.dur > lo)
    return sum(e - s for s, e in merged)


def idle_gaps(ops: Sequence[DeviceOp], window: Tuple[float, float]
              ) -> List[Tuple[float, float]]:
    """The (start, end) spans of ``window`` in which no device op ran."""
    lo, hi = window
    merged = union((max(o.start, lo), min(o.start + o.dur, hi))
                   for o in ops if o.start < hi and o.start + o.dur > lo)
    gaps, at = [], lo
    for s, e in merged:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    return gaps


def _innermost(spans: Sequence[Range], t: float, tid) -> Optional[str]:
    best = None
    for r in spans:
        if r.tid == tid and r.start <= t <= r.start + r.dur:
            if best is None or r.dur < best.dur:
                best = r
    return None if best is None else best.name


def gaps_by_host(ops, ranges, cpu_ops, window, tid, top: int = 10,
                 min_us: float = 10.0):
    """[[what the host was doing, idle seconds]]: each idle gap of at least
    ``min_us`` named by the innermost range and the innermost operator
    open on thread ``tid`` at its middle, summed by name, the ``top``
    largest."""
    total = defaultdict(float)
    starts = sorted(cpu_ops, key=lambda r: r.start)
    keys = [r.start for r in starts]
    for s, e in idle_gaps(ops, window):
        if e - s < min_us:
            continue
        mid = (s + e) / 2
        near = starts[max(0, bisect.bisect_right(keys, mid) - 4000):
                      bisect.bisect_right(keys, mid)]
        rng = _innermost(ranges, mid, tid) or "-"
        op = _innermost(near, mid, tid) or "-"
        total[f"{rng} / {op}"] += (e - s) / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:top]]


def top_ops(ops: Sequence[DeviceOp], top: int = 10):
    """[[device op name, seconds]] summed by name, the ``top`` largest."""
    total = defaultdict(float)
    for o in ops:
        total[o.name[:200]] += o.dur / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:top]]


# ------------------------------------------------- shared by the readers
def range_ms(rec: Dict, name: str) -> Optional[float]:
    """Device ms a call of the ops launched inside range ``name``."""
    ops = [o for o in rec["ops"] if name in o.ranges]
    if not ops or not rec["calls"]:
        return None
    return sum(o.dur for o in ops) / 1e3 / rec["calls"]


def kernel_ms(rec: Dict, names: Sequence[str]) -> Optional[float]:
    """Device ms a call of the kernels whose name holds one of
    ``names``."""
    ops = [o for o in rec["ops"] if any(n in o.name for n in names)]
    if not ops or not rec["calls"]:
        return None
    return sum(o.dur for o in ops) / 1e3 / rec["calls"]


def idle_pct(rec: Dict) -> Optional[float]:
    """100 x (1 - the union of the device's busy intervals over the
    window), from the segment profiled for the device alone."""
    if rec["span_us"] <= 0 or rec["busy_us"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_us"] / rec["span_us"])


def roofline_pct(rec: Dict, key: str, ms: Optional[float]) -> Optional[float]:
    """100 x the bound's time of ``rec[key]`` (bytes, FLOPs) over ``ms``,
    against the card's peaks; None where either is missing."""
    counts, peaks = rec.get(key), rec.get("peaks")
    if not counts or not ms or not peaks:
        return None
    nbytes, flops = counts
    bound_s = max(nbytes / peaks["hbm_bytes_s"], flops / peaks["f32_flops_s"])
    return 100.0 * bound_s / (ms / 1e3)


def mfu_pct(rec: Dict) -> Optional[float]:
    """100 x the reference's FLOPs a call over the profiler-off window's
    time a call and the card's dense bf16 peak."""
    peaks, flops = rec.get("peaks"), rec.get("flops")
    if not peaks or not flops or not rec.get("window_calls"):
        return None
    per_call = rec["window_s"] / rec["window_calls"]
    return 100.0 * flops / per_call / peaks["bf16_flops_s"]


def host_ms(rec: Dict) -> Optional[float]:
    vals = rec.get("host_ms") or []
    return sum(vals) / len(vals) if vals else None
