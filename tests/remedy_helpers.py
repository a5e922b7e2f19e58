"""Shared inputs of the remedy tests (tests/test_torch_port_remedies*.py,
_estimator.py, _ensemble.py): test PSFs, the JAX draws as the port's
injectable draws, the small detector pair (JAX and port on one
torchvision-layout state dict) and the blur estimator's resnet18
weights."""

import jax
import numpy as np
import torch

from synthetic_torch import synthetic_resnet_state_dict
from torch_reference import make_random_fasterrcnn_sd

from detectinblur_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from detectinblur_tpu.models.faster_rcnn import (
    FasterRCNNConfig as JaxFasterRCNNConfig,
)
from detectinblur_tpu.models.roi_heads import BoxHeadConfig as JaxBoxHeadConfig
from detectinblur_tpu.models.rpn import RPNConfig as JaxRPNConfig
from detectinblur_tpu.ops import normalization as jax_norm
from detectinblur_tpu.ops import psf as jax_psf
from detectinblur_tpu.utils.torch_convert import (
    convert_fasterrcnn_bn_stats,
    convert_fasterrcnn_state_dict,
)
from detectinblur_tpu_torch.models.faster_rcnn import (
    FasterRCNN,
    FasterRCNNConfig,
    LossDraws,
)
from detectinblur_tpu_torch.models.roi_heads import BoxHeadConfig
from detectinblur_tpu_torch.models.rpn import RPNConfig
from detectinblur_tpu_torch.train.estimator_engine import CorruptionDraws
from detectinblur_tpu_torch.utils.convert import params_from_torchvision

T = torch.from_numpy


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def psfs(rng):
    """PSFs [6, 128, 128]: an empty one, a single pixel, a diagonal line,
    a horizontal streak, a random blob and a generated camera-shake PSF."""
    p = np.zeros((6, 128, 128), np.float32)
    p[1, 63, 63] = 1.0
    for i in range(20):
        p[2, 50 + i, 55 + i] = 0.05
    p[3, 63, 40:90] = rng.random(50)
    p[4, 55:72, 58:66] = rng.random((17, 8)) * (rng.random((17, 8)) > 0.3)
    p[5] = np.asarray(jax_psf.sample_psf(jax.random.key(3), 0.005, 0.5,
                                         iters=300))
    mass = p.sum(axis=(1, 2), keepdims=True)
    return np.where(mass > 0, p / np.maximum(mass, 1e-20) * 0.5, p)


def jax_corruption_draws(key, shape, noise_level=0.001):
    """The values ``apply_corruptions`` draws from ``key`` for images of
    ``shape``, as a ``CorruptionDraws``."""
    rows = []
    for k in jax.random.split(key, shape[0]):
        kn, kv, kb, kbs, kj, kjq = jax.random.split(k, 6)
        rows.append((jax.random.uniform(kv, (), minval=1e-8, maxval=noise_level),
                     jax.random.normal(kn, shape[1:]),
                     jax.random.uniform(kb),
                     jax.random.uniform(kbs, (), minval=0.6, maxval=1.0),
                     jax.random.uniform(kj),
                     jax.random.uniform(kjq, (), minval=20.0, maxval=90.0)))
    return CorruptionDraws(*(T(np.stack([np.asarray(r[i]) for r in rows]))
                             for i in range(6)))


BUCKET = (64, 64)
HW = np.array([[64, 64], [56, 60]], np.int32)
RPN_KW = dict(pre_nms_top_n_train=200, post_nms_top_n_train=100,
              pre_nms_top_n_test=200, post_nms_top_n_test=100)
BOX_KW = dict(batch_size_per_image=64, nms_pool=256, detections_per_img=20)


def weights(zero_rpn=False, seed=0):
    sd = make_random_fasterrcnn_sd(np.random.default_rng(seed), num_classes=5)
    if zero_rpn:
        sd["rpn.head.cls_logits.weight"][:] = 0
        sd["rpn.head.cls_logits.bias"][:] = [0.3, -0.2, 0.1]
        sd["rpn.head.bbox_pred.weight"][:] = 0
        sd["rpn.head.bbox_pred.bias"][:] = 0
    return sd


def pair(sd, bn_mode, rpn_kw=RPN_KW, box_kw=BOX_KW, warp_=True):
    """(JAX model, params, bn_stats, port model) on one state dict; BN
    unfolded for a bn_mode, its running statistics from the dict with a
    count of 16."""
    common = dict(num_classes=5, min_size=BUCKET[0], max_size=BUCKET[1],
                  warp_internally=warp_, bn_mode=bn_mode)
    jmodel = JaxFasterRCNN(JaxFasterRCNNConfig(
        rpn=JaxRPNConfig(**rpn_kw), box=JaxBoxHeadConfig(**box_kw), **common))
    model = FasterRCNN(FasterRCNNConfig(
        rpn=RPNConfig(**rpn_kw), box=BoxHeadConfig(**box_kw),
        precision="highest", **common), device="cpu")
    params = convert_fasterrcnn_state_dict(sd, frozen_bn=bn_mode is None)
    stats = (None if bn_mode is None
             else convert_fasterrcnn_bn_stats(sd, num_batches=16.0))
    model.load_state_dict(params_from_torchvision(
        sd, 5, frozen_bn=bn_mode is None, num_batches=16.0))
    return jmodel, params, stats, model


def warp_inputs():
    th = np.array([0.7, 0.0], np.float32)
    l1 = np.array([0.82, 1.0], np.float32)
    l2 = np.array([0.93, 1.0], np.float32)
    means = np.tile(jax_norm.CANONICAL_MEAN, (2, 1))
    stds = np.stack([jax_norm.STD_TABLE[1, 3], jax_norm.CANONICAL_STD])
    return th, l1, l2, means, stds.astype(np.float32)


def gt_boxes(rng, B=2, G=4):
    gt = np.zeros((B, G, 4), np.float32)
    gt[..., :2] = rng.uniform(0, 30, (B, G, 2))
    gt[..., 2:] = gt[..., :2] + rng.uniform(10, 30, (B, G, 2))
    labels = rng.integers(1, 5, (B, G)).astype(np.int32)
    valid = np.ones((B, G), bool)
    valid[1, -1] = False
    return gt, labels, valid


def jax_loss_draws(key, B, A, PG):
    keys = jax.random.split(key, (B, 2))

    def uniforms(k, n):
        kp, kn = jax.random.split(k)
        return (np.asarray(jax.random.uniform(kp, (n,))),
                np.asarray(jax.random.uniform(kn, (n,))))

    rpn_d = [uniforms(keys[b, 0], A) for b in range(B)]
    roi_d = [uniforms(keys[b, 1], PG) for b in range(B)]
    stack = lambda ps, i: T(np.stack([p[i] for p in ps]))
    return LossDraws(rpn=(stack(rpn_d, 0), stack(rpn_d, 1)),
                     roi=(stack(roi_d, 0), stack(roi_d, 1)))


N_ANCHORS = 3 * (16 * 16 + 8 * 8 + 4 * 4 + 2 * 2 + 1)


def match(ours, ref):
    """Share of JAX's valid detections matched by label, IoU > 0.95 and
    score within 2e-3 (tests/test_torch_port_eval.py's rule), per image."""
    shares = []
    for b in range(ours.boxes.shape[0]):
        jv = np.asarray(ref.valid[b])
        rb, rs, rl = (np.asarray(a[b])[jv] for a in (ref.boxes, ref.scores,
                                                     ref.labels))
        tv = ours.valid[b].numpy()
        ob, os_, ol = (a[b].numpy()[tv] for a in (ours.boxes, ours.scores,
                                                 ours.labels))
        if not len(rb):
            shares.append(1.0 if not len(ob) else 0.0)
            continue
        lt = np.maximum(rb[:, None, :2], ob[None, :, :2])
        rbt = np.minimum(rb[:, None, 2:], ob[None, :, 2:])
        inter = np.clip(rbt - lt, 0, None).prod(-1)
        area = lambda x: np.clip(x[:, 2:] - x[:, :2], 0, None).prod(-1)
        iou = inter / np.maximum(area(rb)[:, None] + area(ob)[None] - inter,
                                 1e-9)
        iou = iou * (rl[:, None] == ol[None, :])
        best = iou.argmax(1)
        ok = ((iou[np.arange(len(rb)), best] > 0.95)
              & (np.abs(rs - os_[best]) < 2e-3))
        shares.append(ok.mean())
    return shares


def resnet18_sd(num_classes=16, seed=0):
    """torchvision resnet18 layout, convolutions He-scaled, BatchNorms
    near the identity, a small fc."""
    sd = synthetic_resnet_state_dict("resnet18", num_classes=num_classes,
                                     seed=seed)
    rng = np.random.default_rng(seed + 100)
    for k, v in sd.items():
        if v.ndim == 4:
            sd[k] = v * np.float32(np.sqrt(2.0 / np.prod(v.shape[1:])))
        elif k.endswith(("bn1.weight", "bn2.weight", "downsample.1.weight")):
            sd[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif k.endswith(("bias", "running_mean")) and not k.startswith("fc"):
            sd[k] = (0.05 * v).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif k == "fc.weight":
            sd[k] = (v / np.sqrt(v.shape[1])).astype(np.float32)
    return sd
