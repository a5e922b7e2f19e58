"""What the drivers share: the profiled segment of a traced run and the
freeing of the program's state before the reference runs."""

from __future__ import annotations

import gc
import os
import tempfile
import time
from typing import Callable

import torch

from benchmark import trace


def _export(prof):
    """(device ops, ranges, host operators) of a finished profile, through
    a Chrome trace in ``TMPDIR`` that is deleted after."""
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace.load(path)
    finally:
        os.remove(path)


def _cuda_only(call, calls: int, device):
    """(busy us, window us) of ``calls`` calls profiled for the device
    alone, the window timed on the host from a synchronize to one after
    the last call: the idle share without the cost of recording every host
    operator, which slows the host's launches."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            call(i)
        sync(device)
        span = (time.perf_counter() - t0) * 1e6
    ops = _export(prof)[0]
    lo = min((o.start for o in ops), default=0.0)
    return trace.busy_us(ops, (lo, lo + span)), span


def profiled(call: Callable[[int], object], calls: int, device) -> dict:
    """``calls`` calls of ``call`` profiled twice. First for the device
    alone: the union of the device's busy intervals over the host-timed
    window (``busy_us``, ``span_us``). Then host and device, each call in
    a ``bench.call`` range, all in ``bench.traced_window`` with a
    synchronize at its end: the parsed trace (``ops``, ``ranges``,
    ``cpu_ops``, ``window_us``, ``tid``, the window's host thread), whose
    device ops carry the ranges open at their launch. The Chrome trace
    goes through ``TMPDIR`` and is deleted."""
    from torch.profiler import ProfilerActivity, profile, record_function

    busy, span = (_cuda_only(call, calls, device)
                  if torch.device(device).type == "cuda" else (0.0, 1.0))
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        with record_function("bench.traced_window"):
            for i in range(calls):
                with record_function("bench.call"):
                    call(i)
            sync(device)
    ops, ranges, cpu_ops = _export(prof)
    win = max((r for r in ranges if r.name == "bench.traced_window"),
              key=lambda r: r.dur)
    return {"ops": ops, "ranges": ranges, "cpu_ops": cpu_ops,
            "window_us": (win.start, win.start + win.dur), "tid": win.tid,
            "calls": calls, "busy_us": busy, "span_us": span}


def breakdown(rec: dict) -> dict:
    ops = [o for o in rec["ops"] if o.start < rec["window_us"][1]
           and o.start + o.dur > rec["window_us"][0]]
    return {"device_ops": trace.top_ops(ops),
            "idle_gaps": trace.gaps_by_host(ops, rec["ranges"],
                                            rec["cpu_ops"], rec["window_us"],
                                            rec["tid"])}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
