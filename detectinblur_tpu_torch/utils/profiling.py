"""Tracing, step timing and device memory.

Port of ``detectinblur_tpu/utils/profiling.py``:

    with trace("runs/trace"):          # a Chrome trace of what ran inside
        step(...)

    with step_timer() as t:            # wall time after the device is done
        out = step(...)
    print(t.seconds)

    device_memory_stats()              # bytes in use, peak and limit

    with span("norm"):                 # a named range in any such trace
        y = x * scale + bias

``trace`` records the host's operators and, on a CUDA device, the card's
kernels (CUPTI), and writes ``trace.json`` under ``logdir``. ``span`` is
the port's one way to name a stage: a ``record_function`` range (the
trace's ``user_annotation``) while a profiler records, and a shared no-op
otherwise, so a span costs one flag check when nothing is traced.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd.profiler import record_function

_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context naming the block ``name`` in a profiler's trace: a
    ``record_function`` range while a profiler records (``trace``,
    ``torch.profiler.profile``), else a shared no-op. The device work
    launched inside is tied to the range by the launching thread."""
    if _profiler_enabled():
        return record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the block with ``torch.profiler`` and write
    ``{logdir}/trace.json``. CUDA kernels are recorded when ``device`` (the
    current CUDA device when None and a card is present) is a CUDA
    device."""
    from torch.profiler import ProfilerActivity, profile

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class _Timer:
    seconds: float = 0.0


@contextlib.contextmanager
def step_timer(sync=None):
    """Wall time of the block, taken after ``torch.cuda.synchronize()`` when
    ``sync`` (a device, or a tensor on one) is a CUDA device, so that the
    work the block queued on the card is included."""
    t = _Timer()
    t0 = time.perf_counter()
    try:
        yield t
    finally:
        if sync is not None:
            dev = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        t.seconds = time.perf_counter() - t0


def device_memory_stats(device=None) -> dict:
    """``bytes_in_use``, ``peak_bytes_in_use`` (since the last
    ``torch.cuda.reset_peak_memory_stats``) and ``bytes_limit`` (the
    card's memory) of the CUDA allocator; ``{}`` on the CPU, as JAX's on a
    device without statistics."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }
