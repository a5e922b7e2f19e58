"""AugMix with box-aware positional ops, on the host (numpy and PIL).

Port of ``detectinblur_tpu/data/augmix.py`` (``augment_and_mix`` :188),
the reference's augmix/augment_and_mix.py:123-186 and
augmentations.py:60-341:

  * a width-3 Dirichlet(alpha=1) mixture of augmentation chains of depth
    U[1, 3], blended with the clean image by Beta(1, 1), in
    ImageNet-normalized space;
  * non-positional ops: autocontrast, equalize, posterize, solarize;
  * positional ops (``positional``): rotate, shear_x/y, translate_x/y,
    which with ``modify_target_boxes`` also move the boxes (corners
    through the affine, then their bounding box); the chains' boxes merge
    by a per-box min/max union;
  * severity U[1, 10] (positional U[1, 4]) unless given; positional
    magnitudes up to 30 degrees, shear 0.3 and a third of the side, each
    with a random sign.

Every draw comes from the item's own numpy ``Generator``, in the JAX
version's order, so the loaders of both packages give the same batches.
The port's COCO items carry no masks, so neither does this.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from PIL import Image, ImageOps

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def _sample_level(rng, n):
    return rng.uniform(0.1, n)


def _int_param(level, maxval):
    return int(level * maxval / 10)


def _float_param(level, maxval):
    return float(level) * maxval / 10.0


# ------------------------------------------------- non-positional ops
def _autocontrast(img, rng, level):
    return ImageOps.autocontrast(img)


def _equalize(img, rng, level):
    return ImageOps.equalize(img)


def _posterize(img, rng, level):
    bits = 4 - _int_param(_sample_level(rng, level), 4)
    return ImageOps.posterize(img, max(bits, 1))


def _solarize(img, rng, level):
    thresh = 256 - _int_param(_sample_level(rng, level), 256)
    return ImageOps.solarize(img, thresh)


NON_POS_OPS = [_autocontrast, _equalize, _posterize, _solarize]


# ------------------------------------------------- positional ops
def _transform_boxes(boxes, affine_fwd, size):
    """Walk box corners through a forward 2x3 affine; bounding box;
    clamp to the image."""
    if boxes is None or len(boxes) == 0:
        return boxes
    w, h = size
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    corners = np.stack([
        np.stack([x1, y1], -1), np.stack([x2, y1], -1),
        np.stack([x2, y2], -1), np.stack([x1, y2], -1),
    ], 1)  # [N, 4, 2]
    warped = corners @ affine_fwd[:, :2].T + affine_fwd[:, 2]
    out = np.stack([
        warped[..., 0].min(1), warped[..., 1].min(1),
        warped[..., 0].max(1), warped[..., 1].max(1),
    ], -1)
    out[:, 0::2] = out[:, 0::2].clip(0, w - 1)
    out[:, 1::2] = out[:, 1::2].clip(0, h - 1)
    return out.astype(np.float32)


def _affine(img, coeffs, fwd, boxes):
    out = img.transform(img.size, Image.AFFINE, coeffs,
                        resample=Image.BILINEAR)
    return out, _transform_boxes(boxes, fwd, img.size)


def _rotate(img, rng, level, boxes):
    deg = _int_param(_sample_level(rng, level), 30)
    if rng.uniform() > 0.5:
        deg = -deg
    w, h = img.size
    out = img.rotate(deg, resample=Image.BILINEAR)
    rad = -deg / 180.0 * np.pi
    cx, cy = w / 2.0, h / 2.0
    c, s = np.cos(rad), np.sin(rad)
    fwd = np.array([[c, -s, cx - c * cx + s * cy],
                    [s, c, cy - s * cx - c * cy]])
    return out, _transform_boxes(boxes, fwd, img.size)


def _shear_x(img, rng, level, boxes):
    v = _float_param(_sample_level(rng, level), 0.3)
    if rng.uniform() > 0.5:
        v = -v
    return _affine(img, (1, v, 0, 0, 1, 0),
                   np.array([[1.0, -v, 0.0], [0.0, 1.0, 0.0]]), boxes)


def _shear_y(img, rng, level, boxes):
    v = _float_param(_sample_level(rng, level), 0.3)
    if rng.uniform() > 0.5:
        v = -v
    return _affine(img, (1, 0, 0, v, 1, 0),
                   np.array([[1.0, 0.0, 0.0], [-v, 1.0, 0.0]]), boxes)


def _translate_x(img, rng, level, boxes):
    v = _int_param(_sample_level(rng, level), img.size[0] / 3)
    if rng.uniform() > 0.5:
        v = -v
    return _affine(img, (1, 0, v, 0, 1, 0),
                   np.array([[1.0, 0.0, -v], [0.0, 1.0, 0.0]]), boxes)


def _translate_y(img, rng, level, boxes):
    v = _int_param(_sample_level(rng, level), img.size[1] / 3)
    if rng.uniform() > 0.5:
        v = -v
    return _affine(img, (1, 0, 0, 0, 1, v),
                   np.array([[1.0, 0.0, 0.0], [0.0, 1.0, -v]]), boxes)


POS_OPS = [_rotate, _shear_x, _shear_y, _translate_x, _translate_y]


def _normalize(img01):
    return (img01 - MEAN) / STD


def _union_boxes(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return np.stack([
        np.minimum(a[:, 0], b[:, 0]), np.minimum(a[:, 1], b[:, 1]),
        np.maximum(a[:, 2], b[:, 2]), np.maximum(a[:, 3], b[:, 3]),
    ], -1)


def augment_and_mix(image01: np.ndarray, rng: np.random.Generator,
                    boxes: Optional[np.ndarray] = None, severity: int = -1,
                    width: int = 3, depth: int = -1, alpha: float = 1.0,
                    positional: bool = False,
                    modify_target_boxes: bool = False):
    """image01 [H, W, 3] float 0..1 or uint8 -> (mixed [H, W, 3] float32
    0..1, boxes: moved by the positional ops with ``modify_target_boxes``,
    else as given)."""
    if image01.dtype == np.uint8:
        image01 = image01.astype(np.float32) / 255.0
    ws = rng.dirichlet([alpha] * width).astype(np.float32)
    m = np.float32(rng.beta(alpha, alpha))
    if severity == -1:
        sev = int(rng.integers(1, 11))
        pos_sev = int(rng.integers(1, 5))
    else:
        sev = pos_sev = severity

    mix = np.zeros_like(image01)
    boxes_mix = None
    ops = (NON_POS_OPS + POS_OPS) if positional else NON_POS_OPS
    for i in range(width):
        img = Image.fromarray((image01 * 255).astype(np.uint8))
        b = boxes.copy() if boxes is not None else None
        d = depth if depth > 0 else int(rng.integers(1, 4))
        for _ in range(d):
            op = ops[rng.integers(0, len(ops))]
            if op in NON_POS_OPS:
                img = op(img, rng, sev)
            else:
                img, nb = op(img, rng, pos_sev,
                             b if modify_target_boxes else None)
                if modify_target_boxes and nb is not None:
                    b = nb
        mix += ws[i] * _normalize(np.asarray(img, np.float32) / 255.0)
        if modify_target_boxes:
            boxes_mix = _union_boxes(boxes_mix, b)

    mixed = (1 - m) * _normalize(image01) + m * mix
    mixed01 = np.clip(mixed * STD + MEAN, 0.0, 1.0)
    return mixed01.astype(np.float32), (boxes_mix if modify_target_boxes
                                        else boxes)
