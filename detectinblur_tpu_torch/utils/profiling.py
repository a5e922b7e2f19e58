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
otherwise, so a span costs two flag checks when nothing is traced. While
a CUDA graph capture (``utils/graphs.py``) runs under ``cut_at_spans``,
its spans are also where one graph segment ends and the next begins.
Each hand kernel's Python wrapper counts its launches
(``counts_launches``, registered in ``LAUNCH_COUNTERS``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd.profiler import record_function

recording = torch._C._autograd._profiler_enabled   # () -> a profiler records
_NO_SPAN = contextlib.nullcontext()
_cut = None     # while a capture cuts at spans, its hook (``cut_at_spans``)


def span(name: str):
    """A context naming the block ``name`` in a profiler's trace: a
    ``record_function`` range while a profiler records (``trace``,
    ``torch.profiler.profile``), else a shared no-op. The device work
    launched inside is tied to the range by the launching thread. Under
    ``cut_at_spans`` the hook's context, where it gives one."""
    if _cut is not None:
        section = _cut(name)
        if section is not None:
            return section
    if recording():
        return record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def cut_at_spans(hook):
    """While open, ``span(name)`` returns ``hook(name)`` where that is not
    None: a CUDA graph capture's section, which ends one graph segment
    and begins the next (``utils/graphs.py``)."""
    global _cut
    outer, _cut = _cut, hook
    try:
        yield
    finally:
        _cut = outer


LAUNCH_COUNTERS = []   # the hand kernels' wrappers, ``counts_launches``


def counts_launches(wrapper):
    """Register ``wrapper``, a hand kernel's Python wrapper that adds 1 to
    its ``launches`` at each launch. A replay of CUDA graphs runs no
    wrapper: it adds to the wrapper's ``replayed`` the launches its
    capture counted (``utils/graphs.py``)."""
    wrapper.launches = wrapper.replayed = 0
    LAUNCH_COUNTERS.append(wrapper)
    return wrapper


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
