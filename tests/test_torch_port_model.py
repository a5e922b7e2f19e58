"""The port's detector held against the JAX FasterRCNN on the CPU, module by
module and as a whole slice, in ``highest`` precision.

Weights: one torchvision-layout state dict feeds both sides. The JAX side
gets it through ``utils/torch_convert.convert_fasterrcnn_state_dict``; the
port gets that JAX tree through ``params_from_jax``, so the converter is
under test too. The numeric tests use torch_reference's He-scaled random
weights: ``synthetic_fasterrcnn_state_dict`` (unit-normal weights) has the
same keys and shapes and is used for the converter's strict checks, but
its activations overflow float32 through fifty layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_torch import synthetic_fasterrcnn_state_dict
from torch_reference import make_random_fasterrcnn_sd
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

from detectinblur_tpu.models.detection_transform import (
    preprocess_batch as jax_preprocess,
)
from detectinblur_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from detectinblur_tpu.models.faster_rcnn import (
    FasterRCNNConfig as JaxFasterRCNNConfig,
)
from detectinblur_tpu.models.roi_heads import (
    BoxHeadConfig as JaxBoxHeadConfig,
    postprocess_detections as jax_postprocess,
)
from detectinblur_tpu.models.rpn import RPNConfig as JaxRPNConfig
from detectinblur_tpu.models.rpn import filter_proposals as jax_filter
from detectinblur_tpu.models.rpn import run_rpn as jax_run_rpn
from detectinblur_tpu.utils.torch_convert import convert_fasterrcnn_state_dict
from detectinblur_tpu_torch.models.detection_transform import preprocess_batch
from detectinblur_tpu_torch.models.faster_rcnn import (
    FasterRCNN,
    FasterRCNNConfig,
)
from detectinblur_tpu_torch.models.roi_heads import (
    BoxHeadConfig,
    postprocess_detections,
)
from detectinblur_tpu_torch.models.rpn import RPNConfig, filter_proposals
from detectinblur_tpu_torch.utils.convert import params_from_jax

BUCKET = (128, 160)
PRE_NMS, POST_NMS = 400, 200
HW = np.array([[110, 150], [128, 100]], np.int32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True)
def _inference():
    with torch.no_grad():
        yield


def _iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: np.clip(x[:, 2:] - x[:, :2], 0, None).prod(-1)
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-9)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model) sharing one set of weights."""
    sd = make_random_fasterrcnn_sd(np.random.default_rng(0))
    jcfg = JaxFasterRCNNConfig(
        min_size=BUCKET[0], max_size=BUCKET[1],
        rpn=JaxRPNConfig(pre_nms_top_n_test=PRE_NMS,
                         post_nms_top_n_test=POST_NMS),
        box=JaxBoxHeadConfig(nms_pool=2048))
    jparams = convert_fasterrcnn_state_dict(sd)
    tcfg = FasterRCNNConfig(
        min_size=BUCKET[0], max_size=BUCKET[1],
        rpn=RPNConfig(pre_nms_top_n_test=PRE_NMS, post_nms_top_n_test=POST_NMS),
        box=BoxHeadConfig(nms_pool=2048), precision="highest")
    model = FasterRCNN(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(jparams)))
    return JaxFasterRCNN(jcfg), jparams, model


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(2)
    imgs = np.zeros((2, 128, 160, 3), np.float32)
    for b, (h, w) in enumerate(HW):
        imgs[b, :h, :w] = rng.random((h, w, 3), dtype=np.float32)
    return imgs


@pytest.fixture(scope="module")
def jax_stages(pair, images):
    """The JAX side's preprocess output, features and predict output."""
    jmodel, jparams, _ = pair
    batched, new_hw = jax_preprocess(jnp.asarray(images), jnp.asarray(HW),
                                     BUCKET, None, None, BUCKET[0], BUCKET[1])
    feats, _ = jmodel._features(jparams, batched)
    dets = jax.jit(lambda p, im, s: jmodel.predict(p, im, s, bucket=BUCKET))(
        jparams, jnp.asarray(images), jnp.asarray(HW))
    return batched, new_hw, feats, dets


def test_params_from_jax_strict_and_exact():
    sd = synthetic_fasterrcnn_state_dict(seed=0)
    tree = _np_tree(convert_fasterrcnn_state_dict(sd))
    ours = params_from_jax(tree)
    model = FasterRCNN(FasterRCNNConfig(precision="highest"), device="meta")
    assert set(ours) == set(model.state_dict())
    # Unfolded weights come across bit for bit, in torch's layouts.
    for k in ("backbone.body.conv1.weight",
              "backbone.body.layer2.0.conv2.weight",
              "roi_heads.box_head.fc6.weight",
              "roi_heads.box_predictor.bbox_pred.bias"):
        port_key = (k.replace("layer2.0", "layer2_0")
                    .replace("roi_heads.", ""))
        np.testing.assert_array_equal(ours[port_key].numpy(), sd[k])
    del tree["box_head"]["fc7"]
    with pytest.raises(KeyError):
        params_from_jax(tree)
    tree = _np_tree(convert_fasterrcnn_state_dict(sd))
    tree["rpn_head"]["extra"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(KeyError):
        params_from_jax(tree)
    tree = _np_tree(convert_fasterrcnn_state_dict(sd))
    tree["rpn_head"]["conv"]["bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError):
        params_from_jax(tree)


def test_preprocess_matches_jax(images, jax_stages):
    """Bilinear resize + normalize: 1e-4 abs (as tests/test_torch_parity.py
    holds F.interpolate against the JAX resize); valid sizes exact."""
    batched, new_hw = jax_stages[:2]
    ours, ours_hw = preprocess_batch(torch.from_numpy(images), HW, BUCKET,
                                     min_size=BUCKET[0], max_size=BUCKET[1])
    np.testing.assert_array_equal(ours_hw.numpy(), np.asarray(new_hw))
    np.testing.assert_allclose(ours.numpy(), np.asarray(batched), atol=1e-4)


def test_backbone_fpn_matches_jax(pair, jax_stages):
    """P2..P6 from the same preprocessed input: within 2e-3 of each level's
    max magnitude (float32 convolutions summed in other orders through
    fifty layers)."""
    batched, _, jfeats, _ = jax_stages
    ours = pair[2].features(_t(batched))
    assert len(ours) == 5
    for lvl, (o, r) in enumerate(zip(ours, jfeats)):
        r = np.asarray(r)
        assert o.shape == r.shape
        scale = max(np.abs(r).max(), 1e-3)
        np.testing.assert_allclose(o.detach().numpy() / scale, r / scale,
                                   atol=2e-3, err_msg=f"level {lvl}")


def test_filter_proposals_exact_vs_jax(pair, jax_stages):
    """From identical decoded proposals and objectness: identical boxes,
    order and valid mask (the top-k tie-break and NMS are exact)."""
    jmodel, jparams, _ = pair
    _, new_hw, jfeats, _ = jax_stages
    out = jax_run_rpn(jparams["rpn_head"], jmodel.rpn_head, jfeats, new_hw,
                      training=False, cfg=jmodel.cfg.rpn)
    from detectinblur_tpu.ops.boxes import decode_boxes

    props = np.asarray(jax.vmap(lambda d: decode_boxes(
        d, out.anchors, (1.0, 1.0, 1.0, 1.0)))(out.pred_deltas))
    obj = np.array(out.objectness)
    # Duplicate a few scores so the tie-break is exercised.
    obj[:, 10:20] = obj[:, 0:1]
    ref = [jax_filter(props[b], obj[b], out.anchors_per_level, new_hw[b],
                      PRE_NMS, POST_NMS, 0.7, 1e-3) for b in range(2)]
    boxes, valid = filter_proposals(
        _t(props), _t(obj), out.anchors_per_level,
        _t(new_hw), PRE_NMS, POST_NMS, 0.7, 1e-3)
    for b in range(2):
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(ref[b][1]))
        np.testing.assert_array_equal(boxes[b].numpy(), np.asarray(ref[b][0]))


def test_run_rpn_matches_jax(pair, jax_stages):
    """The port's RPN head + decode + filter from the JAX features: at
    least 98% of proposals match a port proposal at IoU > 0.98 (the head
    convolution's float noise can reorder near-tied objectness)."""
    jmodel, jparams, model = pair
    _, new_hw, jfeats, _ = jax_stages
    ref = jax_run_rpn(jparams["rpn_head"], jmodel.rpn_head, jfeats, new_hw,
                      training=False, cfg=jmodel.cfg.rpn)
    feats = [_t(f) for f in jfeats]
    props, valid = model.propose(feats, _t(new_hw))
    for b in range(2):
        r = np.asarray(ref.proposals[b])[np.asarray(ref.proposal_valid[b])]
        o = props[b].numpy()[valid[b].numpy()]
        assert abs(len(o) - len(r)) <= 0.02 * len(r)
        assert (_iou(r, o).max(1) > 0.98).mean() >= 0.98


def test_postprocess_matches_jax(rng):
    """Random head outputs through both postprocesses: the same detections
    (labels and valid exact, boxes and scores to 1e-5)."""
    B, P, C = 2, 60, 6
    logits = rng.normal(0, 2, (B, P, C)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (B, P, C * 4)).astype(np.float32)
    props = rng.uniform(0, 90, (B, P, 4)).astype(np.float32)
    props[..., 2:] = props[..., :2] + rng.uniform(2, 40, (B, P, 2))
    pvalid = rng.random((B, P)) > 0.2
    hw = np.array([[100, 120], [90, 128]], np.int32)
    jcfg = JaxBoxHeadConfig(num_classes=C, detections_per_img=30)
    tcfg = BoxHeadConfig(num_classes=C, detections_per_img=30)
    ours = postprocess_detections(*(torch.from_numpy(a) for a in (
        logits, deltas, props, pvalid, hw)), tcfg)
    for b in range(B):
        ref = jax_postprocess(logits[b], deltas[b], props[b], pvalid[b],
                              hw[b], jcfg)
        assert np.asarray(ref[3]).sum() > 5
        np.testing.assert_array_equal(ours[3][b].numpy(), np.asarray(ref[3]))
        np.testing.assert_array_equal(ours[2][b].numpy(), np.asarray(ref[2]))
        np.testing.assert_allclose(ours[0][b].numpy(), np.asarray(ref[0]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ours[1][b].numpy(), np.asarray(ref[1]),
                                   rtol=1e-5, atol=1e-6)


def test_predict_matches_jax(pair, images, jax_stages):
    """The whole slice, images to detections, in highest precision: at
    least 90% of JAX proposals matched (IoU > 0.98) and 85% of JAX valid
    detections matched by label, IoU > 0.95 and score within 2e-3, as
    tests/test_full_model_parity.py holds the JAX model to its oracle."""
    jmodel, jparams, model = pair
    _, new_hw, _, jdets = jax_stages
    batched, hw_t = model.preprocess(torch.from_numpy(images), HW, BUCKET)
    feats = model.features(batched)
    props, pvalid = model.propose(feats, hw_t)
    jrpn = jax_run_rpn(jparams["rpn_head"], jmodel.rpn_head,
                       jax_stages[2], new_hw, training=False,
                       cfg=jmodel.cfg.rpn)
    dets = model.predict(torch.from_numpy(images), HW, BUCKET)
    assert dets.boxes.shape == (2, 100, 4) and dets.valid.shape == (2, 100)
    for b in range(2):
        r = np.asarray(jrpn.proposals[b])[np.asarray(jrpn.proposal_valid[b])]
        o = props[b].numpy()[pvalid[b].numpy()]
        assert len(r) > 50
        assert (_iou(r, o).max(1) > 0.98).mean() > 0.9

        jv = np.asarray(jdets.valid[b])
        rb, rs, rl = (np.asarray(a[b])[jv] for a in (
            jdets.boxes, jdets.scores, jdets.labels))
        tv = dets.valid[b].numpy()
        ob, os_, ol = (a[b].numpy()[tv] for a in (
            dets.boxes, dets.scores, dets.labels))
        assert len(rb) > 10 and len(ob) > 10
        ious = _iou(rb, ob) * (rl[:, None] == ol[None, :])
        best = ious.argmax(1)
        ok = ((ious[np.arange(len(rb)), best] > 0.95)
              & (np.abs(rs - os_[best]) < 2e-3))
        assert ok.mean() > 0.85, f"image {b}: {ok.mean():.2%} matched"
