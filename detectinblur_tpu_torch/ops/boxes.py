"""Box utilities on padded tensors (port of ``detectinblur_tpu/ops/boxes.py``).

torchvision BoxCoder semantics for decode (dx, dy weights, then dw, dh
clamped at log(1000/16)). Encode and the PSF-driven box expansion are
training code and are not ported yet.
"""

from __future__ import annotations

import math

import torch

# torchvision's bbox_xform_clip.
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [..., 4] xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between [..., N, 4] and [..., M, 4] xyxy boxes ->
    [..., N, M]."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=1e-12)


def clip_boxes_to_image(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clamp xyxy boxes to [0, width] x [0, height] (torchvision semantics).

    ``height``/``width`` are scalars or tensors that broadcast against
    ``boxes[..., 0]``."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    h = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def decode_boxes(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights) -> torch.Tensor:
    """Apply regression ``deltas`` [..., 4] to ``boxes`` [..., 4] xyxy."""
    wx, wy, ww, wh = weights
    x1, y1, x2, y2 = boxes.unbind(-1)
    w = x2 - x1
    h = y2 - y1
    cx = x1 + 0.5 * w
    cy = y1 + 0.5 * h

    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)

    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph],
        dim=-1)
