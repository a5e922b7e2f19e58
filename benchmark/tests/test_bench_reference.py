"""The reference against the port at a small size on the CPU, and the
correctness check against a broken timed path.

In ``highest`` precision (float32, TF32 off) the port and the reference
compute the same function: detections agree exactly and training agrees
to float32 round-off. Each fault that a cell can have, planted under the
timed path of a whole run (set-up, window, check), turns ``correct``
false under the cell's own limits; so does the control, the reference in
float8 training precision, where the cell's limits say it must.
"""

from __future__ import annotations

import contextlib
import time

import pytest
import torch

from benchmark import calibrate, harness, program
from benchmark.drivers import detect, train
from benchmark.harness import sub_seed
from benchmark.run import run_cell
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(old)


def _highest(cell):
    cell.config["precision"] = "highest"
    return cell


def test_detections_match_the_reference_exactly_in_float32():
    c = _highest(tiny.cell("frcnn_r50_fpn", "detect_b8",
                           {"det_mismatch": 0.0}))
    r = run_cell(c, 2 ** 32 + 3, 0.1, False, CPU, time.time())
    assert r["checks"]["det_mismatch"]["value"] == 0.0
    assert r["correct"]


@pytest.mark.parametrize("config", ["frcnn_r50_fpn", "frcnn_mnv2"])
def test_training_matches_the_reference_in_float32(config):
    c = _highest(tiny.cell(config, "train_b8", {}))
    runner = train.Runner(c.config, c.traffic, c.limits, 11, CPU)
    runner.setup()
    numbers = runner.check()["numbers"]
    assert numbers["loss_gap_1"] < 1e-4, numbers
    if config == "frcnn_r50_fpn":
        assert numbers["grad_gap"] < 1e-4, numbers
        assert numbers["update_gap"] < 1e-4, numbers
    else:
        # MobileNetV2's batch statistics over this size's 2 x 2 x 3
        # deepest maps amplify float32 round-off against the float64
        # reference: 3e-3 on the worst leaf of the first gradient, a few
        # per cent after three steps.
        assert numbers["grad_gap"] < 1e-2, numbers


# ---------------------------------------------------------------- faults
@contextlib.contextmanager
def _patched(obj, name, wrap):
    old = getattr(obj, name)
    setattr(obj, name, wrap(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _half_batch_detect(predict):
    """Half of the batch left out: the second half gets no detections."""
    def f(self, images, hw, bucket, **kw):
        det = predict(self, images, hw, bucket, **kw)
        valid = det.valid.clone()
        valid[images.shape[0] // 2:] = False
        return det._replace(valid=valid)
    return f


def _altered_answer(predict):
    """An answer altered where it is produced: one frame's boxes moved."""
    def f(self, images, hw, bucket, **kw):
        det = predict(self, images, hw, bucket, **kw)
        boxes = det.boxes.clone()
        boxes[0] += 40.0
        return det._replace(boxes=boxes)
    return f


@pytest.mark.parametrize("fault", [_half_batch_detect, _altered_answer])
def test_detect_faults_are_not_correct(fault):
    from detectinblur_tpu_torch.models.faster_rcnn import TwoStageDetector

    limits = harness.Cell("frcnn_r50_fpn.detect_b8").limits
    c = tiny.cell("frcnn_r50_fpn", "detect_b8", limits)
    with _patched(TwoStageDetector, "predict", fault):
        r = run_cell(c, 17, 0.1, False, CPU, time.time())
    assert not r["correct"], r["checks"]


def _unchanged_state(step_fn):
    """A step that returns its state unchanged: SGD never moves."""
    def f(self, *a, **k):
        return None
    return f


def _half_batch_train(loss):
    """Half of the batch left out, the mean taken over the rest."""
    def f(self, images, hw, gt_boxes, gt_labels, gt_valid, bucket, **kw):
        h = images.shape[0] // 2
        draws = kw.pop("draws")
        draws = type(draws)(*(tuple(u[:h] for u in pair) for pair in draws))
        return loss(self, images[:h], hw[:h], gt_boxes[:h], gt_labels[:h],
                    gt_valid[:h], bucket, draws=draws, **kw)
    return f


def _altered_loss(loss):
    """An answer altered where it is produced: the losses scaled."""
    def f(self, *a, **k):
        return {n: v * 1.5 for n, v in loss(self, *a, **k).items()}
    return f


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_train_faults_are_not_correct(fault):
    from detectinblur_tpu_torch.models.faster_rcnn import TwoStageDetector

    limits = harness.Cell("frcnn_r50_fpn.train_b8").limits
    c = tiny.cell("frcnn_r50_fpn", "train_b8", limits)
    target, name, wrap = {
        "unchanged": (torch.optim.SGD, "step", _unchanged_state),
        "half": (TwoStageDetector, "loss", _half_batch_train),
        "altered": (TwoStageDetector, "loss", _altered_loss)}[fault]
    with _patched(target, name, wrap):
        r = run_cell(c, 23, 0.1, False, CPU, time.time())
    assert not r["correct"], r["checks"]


# --------------------------------------------------------------- control
def test_detect_control_fails_its_limit():
    """The reference in float8 training precision, put in the program's
    place, reads above the cell's limit (held here at a small size)."""
    limits = harness.Cell("frcnn_r50_fpn.detect_b8").limits
    c = tiny.cell("frcnn_r50_fpn", "detect_b8", limits)
    runner = detect.Runner(c.config, c.traffic, c.limits, 31, CPU)
    runner.setup()
    runner.window(0.1)
    runner.sampled = runner.check()["sampled"]
    state = program.start_weights(c.config, sub_seed(31, 0), CPU, c.traffic)
    ref = program.reference_model(c.config, state, CPU)
    numbers = calibrate._det_reading(runner, ref, True)
    assert any(numbers[k] > v for k, v in limits.items()), numbers
