"""Box utilities on padded tensors (port of ``detectinblur_tpu/ops/boxes.py``).

torchvision BoxCoder semantics for encode and decode (dx, dy weights,
then dw, dh; decode clamps them at log(1000/16)), and the PSF-driven GT
expansion of training (``expand_boxes_by_psf``, ``fix_box_squeeze``).
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


def encode_boxes(reference: torch.Tensor, proposals: torch.Tensor,
                 weights) -> torch.Tensor:
    """Encode ``reference`` (gt) boxes relative to ``proposals`` (anchors)."""
    wx, wy, ww, wh = weights
    px1, py1, px2, py2 = proposals.unbind(-1)
    gx1, gy1, gx2, gy2 = reference.unbind(-1)
    pw = px2 - px1
    ph = py2 - py1
    pcx = px1 + 0.5 * pw
    pcy = py1 + 0.5 * ph
    gw = gx2 - gx1
    gh = gy2 - gy1
    gcx = gx1 + 0.5 * gw
    gcy = gy1 + 0.5 * gh
    return torch.stack([wx * (gcx - pcx) / pw, wy * (gcy - pcy) / ph,
                        ww * torch.log(gw / pw), wh * torch.log(gh / ph)],
                       dim=-1)


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


def fix_box_squeeze(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clamp xyxy boxes into [0, width-1] x [0, height-1] and push the
    edges of degenerate (x1 >= x2 or y1 >= y2) boxes 1 px apart, then clamp
    again (the reference's ``fix_bounding_box_squeeze``). ``height`` and
    ``width`` broadcast against ``boxes[..., 0]``."""
    h = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device) - 1
    w = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device) - 1
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def clamp(x1, y1, x2, y2):
        return (torch.minimum(torch.maximum(x1, zero), w),
                torch.minimum(torch.maximum(y1, zero), h),
                torch.minimum(torch.maximum(x2, zero), w),
                torch.minimum(torch.maximum(y2, zero), h))

    x1, y1, x2, y2 = clamp(*boxes.unbind(-1))
    bad_x = (x1 >= x2).to(boxes.dtype)
    x1, x2 = x1 - bad_x, x2 + bad_x
    bad_y = (y1 >= y2).to(boxes.dtype)
    y1, y2 = y1 - bad_y, y2 + bad_y
    return torch.stack(clamp(x1, y1, x2, y2), dim=-1)


def expand_boxes_by_psf(boxes: torch.Tensor, psfs: torch.Tensor,
                        blurring: torch.Tensor, height,
                        width) -> torch.Tensor:
    """Expand GT boxes [B, G, 4] to cover the smear of their image's
    128x128 PSF [B, 128, 128]: each edge moves by the extent of the PSF's
    nonzero support relative to pixel (63, 63), then the squeeze fix.
    Images with ``blurring`` [B] false pass through unchanged; ``height``
    and ``width`` are [B] valid sizes."""
    if psfs.shape[-1] != 128:
        raise ValueError("expand is only defined for 128-wide PSFs")
    mask = psfs > 0
    coord = torch.arange(128, dtype=torch.float32, device=psfs.device)
    big = torch.tensor(1e9, device=psfs.device)
    xs = torch.where(mask, coord[None, None, :], big)
    ys = torch.where(mask, coord[None, :, None], big)
    left = xs.amin(dim=(1, 2)) - 63.0
    top = ys.amin(dim=(1, 2)) - 63.0
    right = torch.where(mask, coord[None, None, :], -big).amax(dim=(1, 2)) - 63.0
    bottom = torch.where(mask, coord[None, :, None], -big).amax(dim=(1, 2)) - 63.0
    shift = torch.stack([left, top, right, bottom], dim=-1)[:, None]
    expanded = fix_box_squeeze(
        boxes + shift,
        torch.as_tensor(height, device=boxes.device)[:, None],
        torch.as_tensor(width, device=boxes.device)[:, None])
    on = blurring.to(boxes.device).bool()[:, None, None]
    return torch.where(on, expanded, boxes)
