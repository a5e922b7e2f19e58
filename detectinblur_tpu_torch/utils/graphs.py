"""CUDA graphs of a call, captured stage by stage inside its spans.

A call such as ``TwoStageDetector.predict`` launches several hundred
kernels from Python, and on a card the host then needs about as long to
enqueue it as the card needs to run it. ``CallGraphs`` captures such a
call into CUDA graphs and replays them, which costs a few graph launches:

    graphs = CallGraphs("predict", cuts)             # one per model
    out = graphs(device, module, fn, key, tensors, make_consts)

runs ``fn(*tensors, consts)`` for ``module`` on ``device``:

* The key is what the call reads on the host: the caller's ``key`` (for
  predict, ``bucket`` and the bytes of ``hw``), the shape, dtype, device
  and strides of each tensor (None where not given), the device,
  inference mode and the TF32 switches (``call_key``). The first call
  with a key runs ``fn`` eagerly, which also fills the call's caches
  (folded weights, anchors, cuDNN's choices); the second captures it and
  replays it once for its result; later ones replay. A model captures at
  most ``MAX_KEYS`` keys and keeps them: once it holds that many, a
  further key runs eagerly on every call (``full``), so keys that come
  and go never capture graphs that are dropped before they replay. It
  remembers the last ``MAX_SEEN`` keys it saw once, the oldest dropped.
  ``clear()`` drops every key (``TwoStageDetector.loss`` does, before a
  training step writes the weights).
* ``make_consts()`` makes the key's constants once, before the capture
  (for predict, the device copies of ``hw`` and of the resized sizes), so
  no copy from a host buffer is captured.
* A graph replays only while ``module`` is as it was when the model's
  keys were made (``ModuleState``): each submodule, parameter and buffer
  the same object, each tensor at the same ``_version`` and address,
  each module's ``training`` flag and ``mode`` (``AdaptiveBatchNorm``'s)
  the same. Else the call runs eagerly and every key starts anew, its
  graphs dropped: an in-place write (``load_state_dict``, an optimizer
  step between evals), the tensors ``torch.func.functional_call`` swaps
  in (the ensemble's specialists), ``module.to``.
* A tensor that a cache made before the capture and the capture reads (a
  folded weight, ``models/resnet.py``) is passed to ``hold`` and kept
  alive with the graphs, so the cache may replace it meanwhile (a call
  under another inference mode re-folds) while the graphs still read it.
* Before a replay each tensor argument is copied into a buffer the key
  owns, allocated outside the graphs' pool; the outputs (a tensor or a
  tuple of them) are cloned after the last segment, so a later call never
  overwrites what an earlier one returned. Calls replay on the current
  stream, one call's work after the other's.
* The segments follow the spans (``utils/profiling.py::span``): the
  capture runs ``fn`` once on a side stream, and a new segment begins at
  the entry of each span named in ``cuts`` and at its exit into an
  enclosing one (a span nested in another of its name is no boundary).
  The work before the first such span joins the first segment, and work
  after a span that no other encloses joins that span's segment, so no
  segment is empty where every span launches work. Each segment replays
  inside the spans that were open at its capture, so a profiler ties its
  kernels to the same ranges as an eager call's. The segments of a key
  share one memory pool and replay in capture order. A capture runs
  inside the span ``<name>.graph_capture``.
* On the CPU the call always runs eagerly.

``counts`` counts the calls of every model in the process: ``first``
(eager, a new key), ``invalidated`` (eager, the module changed),
``full`` (eager, a repeated key while ``MAX_KEYS`` are captured), ``cpu``
(eager), ``capture`` and ``replay``. A replay runs no Python wrapper: it
adds to each hand kernel's ``replayed`` (``utils/profiling.py::
counts_launches``) what its capture launched.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, Optional, Sequence

import torch
from torch.autograd.profiler import record_function

from detectinblur_tpu_torch.utils.profiling import (
    LAUNCH_COUNTERS,
    cut_at_spans,
    recording,
    span,
)

# Captured keys a model holds. On an H100 a batch-1 key of COCO's sizes
# holds 0.62-0.71 GB of graph pool, and its capture costs 50-75 ms more
# than an eager call, which its replays repay after about 10 (PERF.md,
# section 3): 8 keys, the repo's 5 eval sizes and 3 more, hold at most
# 5.7 GB.
MAX_KEYS = 8
MAX_SEEN = 64     # keys seen once that a model remembers

counts = dict.fromkeys(("first", "invalidated", "full", "cpu", "capture",
                        "replay"), 0)

_capturing = None     # the capture running, if any (``hold``)


def hold(t: torch.Tensor) -> torch.Tensor:
    """``t``, kept alive with the graphs of the capture that the calling
    thread runs, if any: a tensor made before the capture that it reads,
    which its maker may let go of later (a cache's entry)."""
    capture = _capturing
    if capture is not None and threading.get_ident() == capture.thread:
        capture.held.append(t)
    return t


def call_key(device: torch.device, key,
             tensors: Sequence[Optional[torch.Tensor]]):
    """The key of a call on ``device``: the caller's ``key``, each tensor's
    (shape, dtype, device, strides) or None, inference mode and the TF32
    switches."""
    return (key, device, torch.is_inference_mode_enabled(),
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            tuple(None if t is None else (t.shape, t.dtype, t.device,
                                          t.stride()) for t in tensors))


class ModuleState:
    """What ``module`` is made of now; ``holds()`` says whether it still is:
    each submodule, parameter and buffer the same object, each tensor at
    the same ``_version`` (bumped by every in-place write) and address,
    each submodule's ``training`` flag and ``mode`` the same. The root's
    own flags are left out: its predict reads none, and holding its
    attributes would tie the module to itself."""

    def __init__(self, module: torch.nn.Module):
        mods = list(module.modules())
        self._slots = [(d, k, v) for m in mods
                       for d in (m._modules, m._parameters, m._buffers)
                       for k, v in d.items() if v is not None]
        self._tensors = [(t, t._version, t.data_ptr())
                         for _, _, t in self._slots
                         if isinstance(t, torch.Tensor)]
        self._flags = [(m.__dict__, m.training, m.__dict__.get("mode"))
                       for m in mods[1:]]

    def holds(self) -> bool:
        for d, k, v in self._slots:
            if d.get(k) is not v:
                return False
        for t, version, ptr in self._tensors:
            if t._version != version or t.data_ptr() != ptr:
                return False
        for attrs, training, mode in self._flags:
            if attrs["training"] != training or attrs.get("mode") != mode:
                return False
        return True


class _Entry:
    """A key's constants, and once captured its graph segments, static
    inputs and outputs, the tensors it holds (``hold``) and the launches
    its capture counted."""

    def __init__(self):
        self.consts = self.segments = self.inputs = self.outputs = None
        self.held = self.launches = ()


class _Capture:
    """One pass of a call captured as CUDA graph segments into one pool,
    cut at the spans named in ``cuts`` that the capturing thread opens
    (``running``). ``segments`` is [(names of the cut spans open, graph)];
    ``held`` the tensors passed to ``hold`` meanwhile."""

    def __init__(self, cuts: frozenset):
        self.cuts = cuts
        self.pool = torch.cuda.graph_pool_handle()
        self.thread = threading.get_ident()
        self.open = []
        self.started = False
        self.segments = []
        self.held = []
        self._begin()

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        # Other threads (a loader pinning batches) may allocate meanwhile.
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.segments.append((tuple(self.open), graph))

    def _cut(self) -> None:
        self.segments[-1][1].capture_end()
        self._begin()

    @contextlib.contextmanager
    def running(self):
        """While open, the calling thread's spans cut segments and
        ``hold`` keeps tensors for this capture."""
        global _capturing
        outer, _capturing = _capturing, self
        try:
            with cut_at_spans(self.section):
                yield
        finally:
            _capturing = outer

    def section(self, name: str):
        """The hook of ``utils/profiling.py::cut_at_spans``."""
        if name not in self.cuts or threading.get_ident() != self.thread:
            return None
        return self._section(name)

    @contextlib.contextmanager
    def _section(self, name: str):
        nested = bool(self.open) and self.open[-1] == name
        if not nested:
            self.open.append(name)
            if self.started:
                self._cut()
            else:            # the work so far joins the first span's segment
                self.segments[-1] = (tuple(self.open), self.segments[-1][1])
                self.started = True
        try:
            with (record_function(name) if recording()
                  else contextlib.nullcontext()):
                yield
        finally:
            if not nested:
                self.open.pop()
        if not nested and self.open:
            self._cut()

    def end(self) -> None:
        self.segments[-1][1].capture_end()

    def abort(self) -> None:
        """End a capture that raised; the error it ends with is the one
        being raised."""
        try:
            self.segments[-1][1].capture_end()
        except RuntimeError:
            pass


def _fresh(out):
    """A copy of ``out``, a tensor or a (named) tuple of tensors."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(*(_fresh(t) for t in out))


class CallGraphs:
    """The CUDA graphs of one module's calls of one kind (``name``), by
    key; ``cuts`` names the spans at which a capture cuts segments."""

    def __init__(self, name: str, cuts: Sequence[str]):
        self.name = name
        self.cuts = frozenset(cuts)
        self._state = None
        self._entries = collections.OrderedDict()

    def clear(self) -> None:
        """Drop every key and its graphs (their memory goes back to the
        card's cache)."""
        self._state = None
        self._entries.clear()

    def captured(self) -> int:
        """The keys whose graphs this model holds."""
        return sum(e.segments is not None for e in self._entries.values())

    def lookup(self, module: torch.nn.Module, key):
        """(verdict, entry) of a call on a card with the full ``key``
        (``call_key``), counted in ``counts``: ``first``, ``invalidated``
        and ``full`` run eagerly, then ``capture``, then ``replay``."""
        stale = self._state is not None and not self._state.holds()
        if stale:                 # every graph read the module as it was
            self._entries.clear()
        if self._state is None or stale:
            self._state = ModuleState(module)
        entry = self._entries.get(key)
        if entry is None:
            self._entries[key] = entry = _Entry()
            verdict = "invalidated" if stale else "first"
            seen = [k for k, e in self._entries.items() if e.segments is None]
            for k in seen[:max(0, len(seen) - MAX_SEEN)]:
                del self._entries[k]
        else:
            self._entries.move_to_end(key)
            if entry.segments is not None:
                verdict = "replay"
            elif self.captured() < MAX_KEYS:
                verdict = "capture"
            else:
                verdict = "full"
        counts[verdict] += 1
        return verdict, entry

    def __call__(self, device: torch.device, module: torch.nn.Module,
                 fn: Callable, key, tensors: Sequence[Optional[torch.Tensor]],
                 make_consts: Callable):
        if device.type != "cuda":
            counts["cpu"] += 1
            return fn(*tensors, make_consts())
        verdict, entry = self.lookup(module, call_key(device, key, tensors))
        if entry.consts is None:
            entry.consts = make_consts()
        if verdict in ("first", "invalidated", "full"):
            return fn(*tensors, entry.consts)
        if verdict == "capture":
            self._capture(entry, fn, tensors, device)
        for static, t in zip(entry.inputs, tensors):
            if static is not None:
                static.copy_(t)
        for names, graph in entry.segments:
            with contextlib.ExitStack() as spans:
                for name in names:
                    spans.enter_context(span(name))
                graph.replay()
        if verdict == "replay":
            for counter, n in entry.launches:
                counter.replayed += n
        return _fresh(entry.outputs)

    def _capture(self, entry: _Entry, fn: Callable, tensors, device) -> None:
        with span(f"{self.name}.graph_capture"):
            inputs = [None if t is None else torch.empty_like(t, device=device)
                      for t in tensors]
            before = [c.launches for c in LAUNCH_COUNTERS]
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                capture = _Capture(self.cuts)
                with capture.running():
                    try:
                        outputs = fn(*inputs, entry.consts)
                    except BaseException:
                        capture.abort()
                        raise
                capture.end()
            torch.cuda.current_stream(device).wait_stream(stream)
            # cuBLAS keeps the workspace it took from the pool for the
            # capture in a process-wide map. Let it go, so that the pool
            # goes with the graphs, which still use that memory: no other
            # allocation takes from a pool whose capture has ended.
            torch._C._cuda_clearCublasWorkspaces()
        entry.inputs, entry.outputs = inputs, outputs
        entry.segments = tuple(capture.segments)
        entry.held = tuple(capture.held)
        entry.launches = tuple((c, c.launches - b)
                               for c, b in zip(LAUNCH_COUNTERS, before)
                               if c.launches != b)
