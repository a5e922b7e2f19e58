"""The port's spans (``utils/profiling.py::span``) on the CPU: with no
profiler a span is a shared no-op that builds no ``record_function``;
under ``torch.profiler`` each is a ``user_annotation`` range of the
Chrome trace, where the benchmark's readers find them. A train step
records ``train.forward`` around ``loss.backbone`` around one ``norm``
per folded pass (49 for the 53 norms) and one ``norm.fold`` per
trainable folded convolution (42), then ``train.backward`` and
``train.optimizer``, with one ``blur`` and one ``nms``; ``predict`` its
five ``predict.*`` stages with NMS inside the RPN's and the
postprocess's; the eval steps their
``eval.*`` stages. Full ResNet50-FPN widths at a 64x64 bucket, random
weights."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_reference import make_random_fasterrcnn_sd
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

from detectinblur_tpu_torch.models import ensemble
from detectinblur_tpu_torch.models.batchnorm import AdaptiveBatchNorm
from detectinblur_tpu_torch.models.faster_rcnn import (
    FasterRCNN,
    FasterRCNNConfig,
)
from detectinblur_tpu_torch.models.resnet import FrozenBatchNorm
from detectinblur_tpu_torch.models.roi_heads import BoxHeadConfig
from detectinblur_tpu_torch.models.rpn import RPNConfig
from detectinblur_tpu_torch.ops.blur import batched_blur
from detectinblur_tpu_torch.ops.nms import nms
from detectinblur_tpu_torch.train import engine, state
from detectinblur_tpu_torch.utils import profiling
from detectinblur_tpu_torch.utils.profiling import span

BUCKET = (64, 64)
HW = np.array([[64, 64], [56, 60]], np.int32)
RPN_KW = dict(pre_nms_top_n_train=200, post_nms_top_n_train=100,
              pre_nms_top_n_test=200, post_nms_top_n_test=100)
BOX_KW = dict(batch_size_per_image=64, nms_pool=256, detections_per_img=20)
PASSES = 49   # a ResNet-50 forward's folded passes (stem, 3 a block)
PREDICT = ("predict.preprocess", "predict.backbone", "predict.rpn",
           "predict.roi_align", "predict.head_postprocess")


@pytest.fixture(scope="module")
def model():
    from detectinblur_tpu_torch.utils.convert import params_from_torchvision

    m = FasterRCNN(FasterRCNNConfig(
        num_classes=5, min_size=64, max_size=64, rpn=RPNConfig(**RPN_KW),
        box=BoxHeadConfig(**BOX_KW), precision="highest"), device="cpu")
    m.load_state_dict(params_from_torchvision(
        make_random_fasterrcnn_sd(np.random.default_rng(0), 5), 5))
    return m


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    psfs = np.zeros((2, 128, 128), np.float32)
    psfs[:, 60:66, 58:70] = rng.random((2, 6, 12))
    gt = np.array([[[4, 6, 30, 40], [20, 10, 50, 30]],
                   [[0, 0, 12, 12], [30, 30, 55, 50]]], np.float32)
    return engine.BlurBatch(
        images=torch.from_numpy(rng.random((2, 64, 64, 3), np.float32)),
        hw=torch.from_numpy(HW), psfs=torch.from_numpy(psfs),
        blurring=torch.tensor([True, False]),
        gt_boxes=torch.from_numpy(gt),
        gt_labels=torch.ones(2, 2, dtype=torch.int64),
        gt_valid=torch.ones(2, 2, dtype=torch.bool),
        param_index=torch.full((2,), -1, dtype=torch.int32),
        fraction_index=torch.full((2,), -1, dtype=torch.int32))


def _spans(fn, tmp_path):
    """The ``user_annotation`` events of ``fn()`` profiled on the CPU, as
    (name, start, end) in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"),
                  key=lambda s: s[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _count_inside(spans, name, outer):
    return sum(_inside(s, o) for s in _named(spans, name)
               for o in _named(spans, outer))


def test_span_without_a_profiler_builds_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert span("a") is span("b")
    with span("a"):
        pass
    x = torch.rand(1, 3, 16, 16)
    out = batched_blur(x, torch.ones(1, 128, 128), torch.tensor([True]))
    assert out.shape == x.shape
    idx, valid = nms(torch.tensor([[0.0, 0, 4, 4], [0, 0, 4, 5]]),
                     torch.tensor([0.9, 0.8]), 0.5, 2)
    assert valid.tolist() == [True, False] and idx[0] == 0
    FrozenBatchNorm(3)(x)
    AdaptiveBatchNorm(3)(x)


def test_span_under_a_profiler_writes_a_user_annotation(tmp_path):
    def fn():
        with span("probe"):
            torch.ones(4).add_(1)

    spans = _spans(fn, tmp_path)
    assert [s[0] for s in spans] == ["probe"]


@pytest.mark.parametrize("norm", [FrozenBatchNorm, AdaptiveBatchNorm])
def test_each_norm_call_is_one_norm_span(norm, tmp_path):
    layer = norm(3)
    x = torch.rand(2, 3, 8, 8)
    spans = _spans(lambda: (layer(x), layer(x)), tmp_path)
    assert [s[0] for s in spans] == ["norm", "norm"]


def test_a_train_step_records_its_stages(model, tmp_path):
    opt, sched = state.make_optimizer(model, base_lr=1e-4,
                                      steps_per_epoch=2)
    step = engine.make_train_step(model, sched, BUCKET, blur_train=True,
                                  expand_target_boxes=True)
    st = state.create_train_state(model, opt)
    gen = torch.Generator().manual_seed(0)
    st, _ = step(st, _batch(), generator=gen)
    spans = _spans(lambda: step(st, _batch(1), generator=gen), tmp_path)

    once = ("blur", "train.forward", "loss.backbone", "nms",
            "train.backward", "train.optimizer")
    for name in once:
        assert len(_named(spans, name)) == 1, name
    norms = sum(isinstance(m, (FrozenBatchNorm, AdaptiveBatchNorm))
                for m in model.modules())
    assert norms == 53
    # The 53 FrozenBatchNorms fold into their convolutions: one pass a
    # convolution, the downsample's shift riding conv3's, 49 in all.
    assert len(_named(spans, "norm")) == PASSES
    assert _count_inside(spans, "norm", "loss.backbone") == PASSES
    # layer2-4's 42 convolutions train and fold on every step; the stem's
    # and layer1's 11 are frozen and cached.
    assert len(_named(spans, "norm.fold")) == 42
    assert _count_inside(spans, "norm.fold", "loss.backbone") == 42
    assert _count_inside(spans, "loss.backbone", "train.forward") == 1
    assert _count_inside(spans, "nms", "train.forward") == 1
    (fwd,), (bwd,), (opt_,), (blur,) = (
        _named(spans, n) for n in ("train.forward", "train.backward",
                                   "train.optimizer", "blur"))
    assert blur[2] <= fwd[1] and fwd[2] <= bwd[1] and bwd[2] <= opt_[1]


def test_predict_records_its_five_stages_and_nms_inside(model, tmp_path):
    b = _batch()
    model.predict(b.images, HW, BUCKET)     # folds the weights once
    spans = _spans(lambda: model.predict(b.images, HW, BUCKET), tmp_path)
    for name in PREDICT:
        assert len(_named(spans, name)) == 1, name
    assert _count_inside(spans, "norm", "predict.backbone") == PASSES
    assert not _named(spans, "norm.fold")
    assert _count_inside(spans, "nms", "predict.rpn") >= 1
    assert _count_inside(spans, "nms", "predict.head_postprocess") >= 1
    assert {s[0] for s in spans} == set(PREDICT) | {"norm", "nms"}


def test_eval_steps_record_their_stages(model, tmp_path):
    step = engine.make_eval_step(model, BUCKET, blur_eval=True)
    spans = _spans(lambda: step(model, _batch()), tmp_path)
    for name in ("eval.to_device", "eval.blur_expand") + PREDICT:
        assert len(_named(spans, name)) == 1, name
    assert _count_inside(spans, "blur", "eval.blur_expand") == 1

    predict = ensemble.make_ensemble_predict(model, BUCKET)
    stacked = ensemble.stack_specialists([model])
    spans = _spans(lambda: predict(stacked, _batch()), tmp_path)
    names = {s[0] for s in spans}
    assert {"eval.to_device", "eval.blur_expand", *PREDICT} <= names
    assert "ensemble.choose" not in names
