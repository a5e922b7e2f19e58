"""CUDA graphs of ``TwoStageDetector.predict`` (``utils/graphs.py``).

On the CPU predict always runs eagerly, and its outputs are the stage
methods' composition. What a call on a card would do is decided by
``CallGraphs.lookup``, which runs on any device: here a recording
``CallGraphs`` takes the model's place, runs the lookup on the CPU and
predict eagerly, and marks a key captured where a card would capture
it. So the tests below hold which inputs give a new key and which changes
to the module send a call back to the eager path. A capture's segments
follow predict's spans: with ``torch.cuda.CUDAGraph`` stubbed, the CPU
runs predict's stages under a capture and the segments' span names are
checked. Full ResNet50-FPN widths at a 64x64 bucket.

The tests marked ``gpu`` run on a card (``python -m pytest
tests/test_torch_port_graphs.py -q``) and skip here with a reason:
replayed predict against the eager one bit for bit (R50-FPN and
MobileNetV2), the counters, a call under inference mode between a
capture and its replay, two keys in turns, a weight written in place,
the ensemble's ``functional_call``, earlier outputs left alone, the
profiler's ranges around replayed kernels, and the graphs freed with the
model.
"""

import gc

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse fixture)

from detectinblur_tpu_torch.models.faster_rcnn import (
    PREDICT_SPANS,
    FasterRCNN,
    FasterRCNNConfig,
)
from detectinblur_tpu_torch.models.roi_heads import BoxHeadConfig
from detectinblur_tpu_torch.models.rpn import RPNConfig
from detectinblur_tpu_torch.utils import graphs
from detectinblur_tpu_torch.utils.profiling import (
    LAUNCH_COUNTERS,
    cut_at_spans,
)

BUCKET = (64, 64)
HW = np.array([[64, 64], [56, 60]], np.int64)
SMALL = dict(min_size=64, max_size=64,
             rpn=RPNConfig(pre_nms_top_n_test=200, post_nms_top_n_test=100),
             box=BoxHeadConfig(nms_pool=256, detections_per_img=20))


@pytest.fixture(scope="module")
def model():
    return FasterRCNN(FasterRCNNConfig(num_classes=5, precision="highest",
                                       **SMALL), device="cpu", seed=0)


def _images(seed=0, shape=(2, 64, 64, 3)):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(shape, np.float32))


class Recording(graphs.CallGraphs):
    """``CallGraphs`` that looks every call up as a card would, records
    the verdict, marks a key captured where a card would capture it, and
    runs the call eagerly (unless ``run`` is off)."""

    def __init__(self, run=False):
        super().__init__("predict", PREDICT_SPANS)
        self.verdicts, self.run = [], run

    def __call__(self, device, module, fn, key, tensors, make_consts):
        verdict, entry = self.lookup(module,
                                     graphs.call_key(device, key, tensors))
        if verdict == "capture":
            entry.segments = ()
        self.verdicts.append(verdict)
        return fn(*tensors, make_consts()) if self.run else None


@pytest.fixture
def recorded(model, monkeypatch):
    rec = Recording()
    monkeypatch.setattr(model, "_predict_graphs", rec)
    return rec


def test_cpu_predict_runs_eagerly_as_the_stages_compose(model):
    """On the CPU every call is eager (``cpu``), and predict is the stage
    methods' composition, exactly, on every call."""
    images = _images()
    before = dict(graphs.counts)
    outs = [model.predict(images, HW, BUCKET) for _ in range(3)]
    assert graphs.counts["cpu"] == before["cpu"] + 3
    assert {k: graphs.counts[k] - before[k] for k in before
            if k != "cpu"} == dict.fromkeys(
                ("first", "invalidated", "full", "capture", "replay"), 0)
    assert not model._predict_graphs._entries
    with torch.no_grad():
        batched, new_hw = model.preprocess(images, HW, BUCKET)
        feats = model.features(batched)
        props, valid = model.propose(feats, new_hw)
        pooled = model.pool(feats, props, valid)
        ref = model.detect(pooled, props, valid, new_hw, HW)
    for out in outs:
        for got, want in zip(out, ref):
            assert torch.equal(got, want)
    assert outs[0].valid.any()


def _strided(images):
    """``images`` as a view of another layout: the same shape and
    values, other strides."""
    return images.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


# name -> the predict arguments of a call that must give another key.
VARIANTS = {
    "hw": lambda: (_images(), HW - [[0, 0], [8, 4]], BUCKET, {}),
    "bucket": lambda: (_images(), HW, (64, 96), {}),
    "shape": lambda: (_images(shape=(2, 64, 72, 3)), HW, BUCKET, {}),
    "batch": lambda: (_images(shape=(1, 64, 64, 3)), HW[:1], BUCKET, {}),
    "dtype": lambda: (_images().double(), HW, BUCKET, {}),
    "strides": lambda: (_strided(_images()), HW, BUCKET, {}),
    "means_given": lambda: (_images(), HW, BUCKET, dict(
        means=torch.full((2, 3), 0.4), stds=torch.full((2, 3), 0.2))),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_other_inputs_give_a_new_key(model, recorded, variant):
    """The second call with a key captures and later ones replay; a call
    that differs in ``hw``, ``bucket``, the images' shape, dtype or
    strides, or in which optional inputs it gives, is a key's first."""
    images, hw, bucket, kw = VARIANTS[variant]()
    model.predict(_images(), HW, BUCKET)
    model.predict(_images(1), HW.astype(np.int32), list(BUCKET))
    model.predict(images, hw, bucket, **kw)
    model.predict(_images(2), HW, BUCKET)
    model.predict(images, hw, bucket, **kw)
    assert recorded.verdicts == ["first", "capture", "first", "replay",
                                 "capture"]


def _write_param(model):
    with torch.no_grad():
        model.box_predictor.cls_score.bias.add_(0.0)


def _write_frozen_norm(model):
    with torch.no_grad():
        model.backbone.body.layer1_0.bn2.scale.mul_(1.0)


def _train_mode(model):
    model.backbone.fpn.train()


def _swap_module(model):
    model.rpn_head.cls_logits = torch.nn.Identity()


def _swap_param(model):
    model.box_head.fc7.weight = torch.nn.Parameter(
        model.box_head.fc7.weight.detach().clone())


# name -> a change to the module after which a call runs eagerly.
CHANGES = {"param_written": _write_param,
           "frozen_norm_written": _write_frozen_norm,
           "train_mode": _train_mode,
           "module_swapped": _swap_module,
           "param_swapped": _swap_param}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_a_changed_module_runs_eagerly(change, monkeypatch):
    """A captured key runs eagerly (``invalidated``) after an in-place
    write to a parameter or a folded norm's buffer, a switch to training
    mode, or a submodule or parameter replaced; the next call with the
    module as it now is captures anew."""
    model = FasterRCNN(FasterRCNNConfig(num_classes=5, **SMALL),
                       device="cpu", seed=0)
    rec = Recording()
    monkeypatch.setattr(model, "_predict_graphs", rec)
    for seed in range(3):
        model.predict(_images(seed), HW, BUCKET)
    CHANGES[change](model)
    for seed in range(3):
        model.predict(_images(seed), HW, BUCKET)
    assert rec.verdicts == ["first", "capture", "replay",
                            "invalidated", "capture", "replay"]


def test_functional_call_runs_eagerly(model, recorded):
    """The ensemble runs each specialist's tensors through the template
    with ``torch.func.functional_call``: tensors other than the module's
    own send the call to the eager path, and so does the module's own
    coming back after; the eager call computes with the tensors passed."""
    for seed in range(3):
        model.predict(_images(seed), HW, BUCKET)
    recorded.run = True
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    got = torch.func.functional_call(model, weights, (_images(), HW, BUCKET))
    want = model.predict(_images(), HW, BUCKET)
    assert recorded.verdicts == ["first", "capture", "replay",
                                 "invalidated", "invalidated"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_the_oldest_key_is_dropped(model, recorded):
    """A model remembers ``MAX_SEEN`` keys seen once: one more drops the
    oldest, whose next call is a first again, while the newest keep
    theirs."""
    images = _images()
    hws = [HW - [[0, 0], [i // 8, i % 8]] for i in range(graphs.MAX_SEEN + 1)]
    for hw in hws:
        model.predict(images, hw, BUCKET)
    model.predict(images, hws[-1], BUCKET)
    model.predict(images, hws[0], BUCKET)
    assert recorded.verdicts == ["first"] * (graphs.MAX_SEEN + 1) + [
        "capture", "first"]
    assert len(model._predict_graphs._entries) == graphs.MAX_SEEN + 1


def test_a_full_model_runs_further_keys_eagerly(model, recorded):
    """A model captures ``MAX_KEYS`` keys and keeps them: a further key
    repeated runs eagerly (``full``) on every call, and keys seen once
    after them, however many, drop none of them."""
    images = _images()
    hws = [HW - [[0, 0], [i, 0]] for i in range(graphs.MAX_KEYS + 1)]
    for hw in hws + hws:
        model.predict(images, hw, BUCKET)
    for i in range(graphs.MAX_SEEN + 1):
        model.predict(images, HW - [[0, 0], [0, 1 + i % 7]] - [[0, 0], [
            i // 7, 0]], BUCKET)
    for hw in hws:
        model.predict(images, hw, BUCKET)
    keys = graphs.MAX_KEYS
    assert recorded.verdicts == (
        ["first"] * (keys + 1) + ["capture"] * keys + ["full"]
        + ["first"] * (graphs.MAX_SEEN + 1) + ["replay"] * keys + ["first"])
    assert model._predict_graphs.captured() == keys


def test_loss_drops_the_graphs(model, recorded):
    """``loss`` drops predict's keys and graphs, whose weights the step
    that follows writes: the next predict is a key's first."""
    for seed in range(3):
        model.predict(_images(seed), HW, BUCKET)
    gt = torch.tensor([[[4.0, 4.0, 30.0, 30.0]], [[8.0, 8.0, 40.0, 40.0]]])
    with torch.no_grad():
        model.loss(_images(), HW, gt, torch.ones(2, 1, dtype=torch.int64),
                   torch.ones(2, 1, dtype=torch.bool), BUCKET,
                   generator=torch.Generator().manual_seed(0))
    assert not recorded._entries
    model.predict(_images(), HW, BUCKET)
    assert recorded.verdicts == ["first", "capture", "replay", "first"]


class _StubGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: records its capture's bounds."""

    def __init__(self):
        self.state = "new"

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert self.state == "new" and capture_error_mode == "thread_local"
        self.state = "capturing"

    def capture_end(self):
        assert self.state == "capturing"
        self.state = "captured"


def test_capture_cuts_a_segment_at_each_stage_and_nms(model, monkeypatch):
    """With CUDA graphs stubbed, predict's stages run under a capture on
    the CPU: one segment a ``predict.*`` stage, the RPN's and the
    postprocess's split around their ``nms`` (the postprocess's nested
    ``nms`` spans make one), each named by the spans open at its capture,
    every graph ended; the 49 ``norm`` spans cut nothing."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    plan = model._plan(HW, BUCKET)
    capture = graphs._Capture(frozenset(PREDICT_SPANS))
    with torch.no_grad(), cut_at_spans(capture.section):
        model._predict(_images(), None, None, None, None, None, plan)
    capture.end()
    rpn, post = "predict.rpn", "predict.head_postprocess"
    assert [names for names, _ in capture.segments] == [
        ("predict.preprocess",), ("predict.backbone",), (rpn,),
        (rpn, "nms"), (rpn,), ("predict.roi_align",), (post,),
        (post, "nms"), (post,)]
    assert {g.state for _, g in capture.segments} == {"captured"}


def test_a_capture_holds_the_folds_it_reads(model, monkeypatch):
    """A capture keeps every folded weight and summed shift it reads
    (``graphs.hold``): a call under inference mode re-folds each into the
    cache, and the capture still holds what it read, unchanged. Outside a
    capture nothing is held."""
    from detectinblur_tpu_torch.models import resnet

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    plan = model._plan(HW, BUCKET)
    with torch.no_grad():       # a key's first call fills the cache
        model._predict(_images(), None, None, None, None, None, plan)
    capture = graphs._Capture(frozenset(PREDICT_SPANS))
    with torch.no_grad(), capture.running():
        model._predict(_images(), None, None, None, None, None, plan)
    capture.end()
    cached = [resnet._DERIVED[m][2] for m in model.modules()
              if m in resnet._DERIVED]
    assert len(cached) == 57        # 53 folded weights, 4 summed shifts
    assert {id(t) for t in capture.held} == {id(t) for t in cached}
    kept = [t.clone() for t in capture.held]
    with torch.inference_mode():
        model._predict(_images(), None, None, None, None, None, plan)
    held = {id(t) for t in capture.held}
    assert not any(id(resnet._DERIVED[m][2]) in held for m in model.modules()
                   if m in resnet._DERIVED)
    assert all(torch.equal(t, k) for t, k in zip(capture.held, kept))
    assert graphs.hold(kept[0]) is kept[0] and len(capture.held) == 57


# ---------------------------------------------------------------- the card
CARD_BUCKET = (96, 128)
CARD_HW = np.array([[96, 128], [90, 110]], np.int64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_model(cuda, kind="r50_fpn", seed=0):
    """A detector on the card in throughput precision, with 2 classes so
    that many boxes score above the threshold."""
    if kind == "r50_fpn":
        return FasterRCNN(FasterRCNNConfig(
            num_classes=2, min_size=96, max_size=128, precision="default"),
            device=cuda, seed=seed)
    from detectinblur_tpu_torch.models.backbones import (
        SingleMapConfig,
        SingleMapFasterRCNN,
    )
    return SingleMapFasterRCNN(SingleMapConfig(
        backbone="mobile_net", num_classes=2, min_size=96, max_size=128,
        precision="default"), device=cuda, seed=seed)


def _card_images(cuda, seed):
    return _images(seed, (2, 96, 128, 3)).to(cuda)


def _eager(model, *args, **kw):
    """``model.predict`` run eagerly, whatever its graphs hold."""
    held = model._predict_graphs
    model._predict_graphs = Recording(run=True)
    try:
        return model.predict(*args, **kw)
    finally:
        model._predict_graphs = held


def _same(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _counted(fn):
    """(fn(), the change of ``graphs.counts``, and of each hand kernel's
    launches through its wrapper and its launches in replayed graphs,
    while it ran)."""
    before = dict(graphs.counts)
    launches = [(c.launches, c.replayed) for c in LAUNCH_COUNTERS]
    out = fn()
    torch.cuda.synchronize()
    return out, ({k: v - before[k] for k, v in graphs.counts.items() if
                  v != before[k]},
                 [(c.launches - n, c.replayed - r) for c, (n, r) in zip(
                     LAUNCH_COUNTERS, launches)])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["r50_fpn", "mobile_net"])
def test_replay_equals_eager_bit_for_bit(cuda, kind):
    """The first call runs eagerly, the second captures and replays, the
    third replays: the counters say so, the capture launches through the
    wrappers what the eager call launched, the replay launches nothing
    through them and adds as much to their ``replayed``, and every output
    equals the eager predict's on its own images bit for bit."""
    model = _card_model(cuda, kind)
    calls = []
    for seed in range(3):
        images = _card_images(cuda, seed)
        calls.append((_counted(lambda: model.predict(images, CARD_HW,
                                                     CARD_BUCKET)), images))
    assert [c[0][1][0] for c in calls] == [
        {"first": 1}, {"capture": 1}, {"replay": 1}]
    eager = [n for n, _ in calls[0][0][1][1]]
    names = [c.__name__ for c in LAUNCH_COUNTERS]
    assert eager[names.index("roi_align_fwd")] == 1
    assert eager[names.index("nms_alive")] == 2
    assert calls[1][0][1][1] == [(n, 0) for n in eager]
    assert calls[2][0][1][1] == [(0, n) for n in eager]
    for (out, _), images in calls:
        want = _eager(model, images, CARD_HW, CARD_BUCKET)
        assert want.valid.any()
        assert _same(out, want)


@pytest.mark.gpu
def test_a_call_under_inference_mode_leaves_the_graphs_weights(cuda):
    """A call under ``torch.inference_mode`` is another key: it runs
    eagerly and re-folds every folded weight into the cache, in place of
    those the no-grad graphs read. The graphs keep theirs: the next
    no-grad call replays and equals the eager predict bit for bit."""
    model = _card_model(cuda)
    for seed in range(2):
        model.predict(_card_images(cuda, seed), CARD_HW, CARD_BUCKET)
    with torch.inference_mode():
        for seed in range(2):
            model.predict(_card_images(cuda, seed), CARD_HW, CARD_BUCKET)
    junk = [torch.full_like(p, 7.0) for p in model.parameters()]
    images = _card_images(cuda, 2)
    out, (counted, _) = _counted(
        lambda: model.predict(images, CARD_HW, CARD_BUCKET))
    del junk
    assert counted == {"replay": 1}
    want = _eager(model, images, CARD_HW, CARD_BUCKET)
    assert want.valid.any()
    assert _same(out, want)


@pytest.mark.gpu
def test_two_keys_in_turns_match_eager(cuda):
    """Two ``hw`` called in turns each capture on their second call and
    replay after, each equal to the eager predict."""
    model = _card_model(cuda)
    hws = (CARD_HW, CARD_HW - [[0, 0], [20, 30]])
    verdicts = []
    for seed in range(6):
        images, hw = _card_images(cuda, seed), hws[seed % 2]
        out, (counted, _) = _counted(
            lambda: model.predict(images, hw, CARD_BUCKET))
        verdicts.append(counted)
        assert _same(out, _eager(model, images, hw, CARD_BUCKET))
    assert verdicts == [{"first": 1}] * 2 + [{"capture": 1}] * 2 + [
        {"replay": 1}] * 2


@pytest.mark.gpu
def test_a_weight_written_in_place_is_read(cuda):
    """After a frozen norm's scale (folded into its convolution) and a
    classifier bias are written in place, predict runs eagerly, then
    captures anew: its outputs follow the new weights."""
    model = _card_model(cuda)
    images = _card_images(cuda, 0)
    for _ in range(3):
        old = model.predict(images, CARD_HW, CARD_BUCKET)
    with torch.no_grad():
        model.backbone.body.layer1_0.bn2.scale.mul_(1.5)
        model.box_predictor.cls_score.bias.add_(0.3)
    want = _eager(model, images, CARD_HW, CARD_BUCKET)
    assert not _same(old, want)
    verdicts = []
    for _ in range(3):
        out, (counted, _) = _counted(
            lambda: model.predict(images, CARD_HW, CARD_BUCKET))
        verdicts.append(counted)
        assert _same(out, want)
    assert verdicts == [{"invalidated": 1}, {"capture": 1}, {"replay": 1}]


@pytest.mark.gpu
def test_the_ensembles_functional_call_matches_eager(cuda):
    """The ensemble's gather of a specialist's stacked tensors and
    ``functional_call`` through the template run eagerly on every call
    and equal the specialist's own predict."""
    from detectinblur_tpu_torch.models.ensemble import (
        select_specialist,
        stack_specialists,
    )

    models = [_card_model(cuda, seed=s) for s in (0, 1)]
    stacked = stack_specialists(models)
    index = torch.tensor(1, device=cuda)
    images = _card_images(cuda, 0)
    want = _eager(models[1], images, CARD_HW, CARD_BUCKET)
    verdicts = []
    for _ in range(3):
        weights = {**select_specialist(stacked.params, index),
                   **select_specialist(stacked.buffers, index)}
        out, (counted, _) = _counted(lambda: torch.func.functional_call(
            models[0], weights, (images, CARD_HW, CARD_BUCKET)))
        verdicts.append(counted)
        assert _same(out, want)
    assert verdicts == [{"first": 1}] + [{"invalidated": 1}] * 2


@pytest.mark.gpu
def test_a_returned_detections_outlives_the_next_call(cuda):
    """Replays write their graphs' outputs in place; what a call returned
    is its own copy, unchanged by the calls after it."""
    model = _card_model(cuda)
    for seed in range(2):
        model.predict(_card_images(cuda, seed), CARD_HW, CARD_BUCKET)
    first = model.predict(_card_images(cuda, 2), CARD_HW, CARD_BUCKET)
    kept = [t.clone() for t in first]
    second = model.predict(_card_images(cuda, 3), CARD_HW, CARD_BUCKET)
    torch.cuda.synchronize()
    assert _same(first, kept)
    assert not _same(first, second)


@pytest.mark.gpu
def test_replayed_kernels_sit_in_the_stages_ranges(cuda, tmp_path):
    """Under ``torch.profiler`` each replayed segment's kernels are tied
    (by the correlation id of their graph launch) to the ranges of the
    spans open at its capture, as the benchmark's trace reader finds
    them: each ``predict.*`` stage and ``nms`` holds the same kernels as
    in an eager call, RoIAlign's kernel under ``predict.roi_align``."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace

    model = _card_model(cuda)
    images = _card_images(cuda, 0)
    for _ in range(2):
        model.predict(images, CARD_HW, CARD_BUCKET)

    def kernels(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = str(tmp_path / "trace.json")
        prof.export_chrome_trace(path)
        ops = trace.load(path)[0]
        # A graph's memsets and copies show as other ops than an eager
        # call's (``memset32``, ``memcpy32_post``): kernels alone compare.
        return {name: sorted(o.name for o in ops if name in o.ranges
                             and not o.name.lower().startswith("mem"))
                for name in PREDICT_SPANS}

    (replayed, (counted, _)) = _counted(lambda: kernels(
        lambda: model.predict(images, CARD_HW, CARD_BUCKET)))
    assert counted == {"replay": 1}
    eager = kernels(lambda: _eager(model, images, CARD_HW, CARD_BUCKET))
    assert all(replayed.values())
    assert replayed == eager
    assert any("roi_align_fwd_kernel" in k
               for k in replayed["predict.roi_align"])


@pytest.mark.gpu
def test_the_graphs_go_with_the_model(cuda):
    """Deleting a model whose predict was captured frees its graphs'
    memory with it: the card's allocated and reserved bytes come back to
    where they were before the model was built."""
    warm = _card_model(cuda)
    for seed in range(3):
        warm.predict(_card_images(cuda, seed), CARD_HW, CARD_BUCKET)
    del warm
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    model = _card_model(cuda)
    for seed in range(3):
        model.predict(_card_images(cuda, seed), CARD_HW, CARD_BUCKET)
    assert len(model._predict_graphs._entries) == 1
    del model
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert (torch.cuda.memory_allocated(),
            torch.cuda.memory_reserved()) == before
