"""The readers of the program's own spans (``benchmark/spans.py`` and the
metrics that read ``blur``, ``norm``, ``nms``, ``loss.backbone`` and the
train step's ``train.*`` spans) on hand-built Chrome-trace events:

- an op launched from a second thread with no range open counts in
  ``backward_ms.train`` and nowhere else;
- an op under nested spans of one name counts once;
- an idle gap goes to the span open at its middle on the window's
  thread, and a span of another thread takes none;
- a trace without the span reads None, as a program without it gives.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import pytest

from benchmark import harness, spans, trace

MAIN, AUTOGRAD, OTHER = 1, 2, 3


def _range(name, start, end, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": start,
            "dur": end - start, "tid": tid}


def _launch(corr, at, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": at, "dur": 1, "tid": tid, "args": {"correlation": corr}}


def _kernel(corr, start, end):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": start,
            "dur": end - start, "tid": 7, "args": {"correlation": corr}}


def _rec(events, calls=2):
    ops, ranges, cpu_ops = trace.parse(events)
    win = next(r for r in ranges if r.name == "bench.traced_window")
    return {"ops": ops, "ranges": ranges, "cpu_ops": cpu_ops,
            "window_us": (win.start, win.start + win.dur), "tid": win.tid,
            "calls": calls}


# Two train steps' worth of one step (calls=2 halves every sum), in us.
# Device busy: 20-40 blur; 80-100, 110-130 norms and 130-170 the rest of
# the backbone; 270-300 nms (launched under two nested nms spans);
# 300-350 the losses; 440-650 the backward from autograd's thread and
# 680-700 one launched from the main thread's train.backward; 750-790 SGD.
TRAIN_RANGES = [
    _range("bench.traced_window", 0, 1000), _range("bench.call", 0, 1000),
    _range("blur", 5, 40), _range("train.forward", 50, 400),
    _range("loss.backbone", 60, 200), _range("norm", 70, 90),
    _range("norm", 100, 120), _range("nms", 250, 300),
    _range("nms", 260, 290), _range("train.backward", 400, 700),
    _range("train.optimizer", 700, 800),
    # Another thread's span over the gap 700-750: not the window's thread.
    _range("train.backward", 700, 760, tid=OTHER),
]
# (correlation, launch time, launching thread, kernel start, kernel end)
TRAIN_OPS = [
    (1, 20, MAIN, 20, 40), (2, 80, MAIN, 80, 100), (3, 110, MAIN, 110, 130),
    (4, 150, MAIN, 130, 170), (5, 270, MAIN, 270, 300),
    (6, 350, MAIN, 300, 350), (7, 750, MAIN, 750, 790),
    (8, 450, AUTOGRAD, 440, 650), (9, 450, MAIN, 680, 700),
]


def _events(ranges, ops):
    ev = list(ranges)
    for corr, at, tid, s, e in ops:
        ev += [_launch(corr, at, tid), _kernel(corr, s, e)]
    return ev


def _read(metric, rec):
    return harness.reader(metric)(rec)


@pytest.fixture
def train_rec():
    return _rec(_events(TRAIN_RANGES, TRAIN_OPS))


TRAIN_MS = {  # device us a step of each span's ops, / 1e3
    "blur_ms.train": 20 / 2e3,
    "forward_ms.train": (20 + 20 + 40 + 30 + 50) / 2e3,
    "backbone_ms.train": (20 + 20 + 40) / 2e3,
    "norm_ms.train": (20 + 20) / 2e3,
    "nms_ms.train": 30 / 2e3,
    "backward_ms.train": (210 + 20) / 2e3,
    "optimizer_ms.train": 40 / 2e3,
}


@pytest.mark.parametrize("metric", sorted(TRAIN_MS))
def test_train_span_readers_on_hand_built_events(train_rec, metric):
    assert _read(metric, train_rec) == pytest.approx(TRAIN_MS[metric])


def test_an_op_from_another_thread_counts_only_in_the_backward(train_rec):
    """Kernel 8 (210 us) was launched from a thread with no range open:
    the backward's, and no other metric's."""
    without = _rec(_events(TRAIN_RANGES,
                           [o for o in TRAIN_OPS if o[0] != 8]))
    for metric in TRAIN_MS:
        moved = _read(metric, train_rec) - _read(metric, without)
        want = 210 / 2e3 if metric == "backward_ms.train" else 0.0
        assert moved == pytest.approx(want, abs=1e-12), metric
    # Launched from the main thread, its ranges are that thread's.
    assert next(o for o in train_rec["ops"] if o.name == "k8").ranges \
        == frozenset()


def test_nested_spans_of_one_name_count_an_op_once(train_rec):
    assert _read("nms_ms.train", train_rec) == pytest.approx(30 / 2e3)
    op = next(o for o in train_rec["ops"] if o.name == "k5")
    assert {"nms", "train.forward"} <= op.ranges


def test_idle_gaps_go_to_the_span_open_at_their_middle(train_rec):
    """Gaps: 0-20 (blur), 40-80, 100-110, 170-270 and 350-440 (forward:
    240 us), 650-680 (backward), 700-750 (the optimizer on the window's
    thread, another thread's train.backward: not the backward's),
    790-1000 (bench.call alone)."""
    assert _read("forward_idle_ms.train", train_rec) == pytest.approx(
        (40 + 10 + 100 + 90) / 2e3)
    assert _read("backward_idle_ms.train", train_rec) == pytest.approx(
        30 / 2e3)


# A detect call: norm in the backbone, the RPN's grouped NMS, the
# postprocess's batched NMS around nms; gaps 60-70 in the backbone, 120-150
# in the RPN, 200-230 and 260-300 in the postprocess.
DETECT_RANGES = [
    _range("bench.traced_window", 0, 300), _range("bench.call", 0, 300),
    _range("predict.backbone", 0, 100), _range("norm", 10, 20),
    _range("predict.rpn", 100, 180), _range("nms", 110, 170),
    _range("predict.head_postprocess", 180, 300), _range("nms", 190, 250),
    _range("nms", 195, 245),
]
DETECT_OPS = [
    (1, 15, MAIN, 0, 40), (2, 50, MAIN, 40, 60), (3, 80, MAIN, 70, 120),
    (4, 150, MAIN, 150, 180), (5, 185, MAIN, 180, 200),
    (6, 200, MAIN, 230, 260),
]


def test_detect_span_readers_on_hand_built_events():
    rec = _rec(_events(DETECT_RANGES, DETECT_OPS), calls=1)
    assert _read("norm_ms.detect", rec) == pytest.approx(0.040)
    assert _read("nms_ms.detect", rec) == pytest.approx(0.030 + 0.030)
    assert _read("postprocess_idle_ms.detect", rec) == pytest.approx(
        0.030 + 0.040)
    # The RPN's gap (120-150) is the RPN's, not the postprocess's.
    assert spans.idle_ms(rec, "predict.rpn") == pytest.approx(0.030)


NEW = sorted(TRAIN_MS) + ["forward_idle_ms.train", "backward_idle_ms.train",
                          "norm_ms.detect", "nms_ms.detect",
                          "postprocess_idle_ms.detect"]


@pytest.mark.parametrize("metric", NEW)
def test_a_trace_without_the_span_reads_none(metric):
    """The harness's own ranges and ops, one from a second thread, and
    none of the program's spans: what a program without them gives."""
    rec = _rec(_events(TRAIN_RANGES[:2], TRAIN_OPS))
    assert _read(metric, rec) is None
