"""Fast R-CNN box head and detection postprocess, inference only.

Port of ``detectinblur_tpu/models/roi_heads.py`` (``TwoMLPHead`` :31,
``FastRCNNPredictor`` :54, ``BoxHeadConfig`` :75,
``postprocess_detections`` :173), batched over the images. Roi sampling
and the loss are training code and are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from detectinblur_tpu_torch.ops.boxes import clip_boxes_to_image, decode_boxes
from detectinblur_tpu_torch.ops.nms import NEG_INF, batched_nms

BOX_CODER_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


class TwoMLPHead(nn.Module):
    """fc6 -> relu -> fc7 -> relu over pooled rois flattened in torch CHW
    order (the reference's fc6 weights expect it, faster_rcnn.py:174)."""

    def __init__(self, in_channels: int = 256, resolution: int = 7,
                 representation_size: int = 1024):
        super().__init__()
        self.fc6 = nn.Linear(in_channels * resolution * resolution,
                             representation_size)
        self.fc7 = nn.Linear(representation_size, representation_size)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        """pooled [N, 7, 7, C] (HWC) -> [N, representation_size]."""
        x = pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1)
        x = F.relu(self.fc6(x))
        return F.relu(self.fc7(x))


class FastRCNNPredictor(nn.Module):
    """Class logits and per-class box deltas, emitted in float32 (softmax,
    threshold, NMS and box decode follow)."""

    def __init__(self, in_channels: int = 1024, num_classes: int = 91):
        super().__init__()
        self.cls_score = nn.Linear(in_channels, num_classes)
        self.bbox_pred = nn.Linear(in_channels, num_classes * 4)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class BoxHeadConfig(NamedTuple):
    num_classes: int = 91
    fg_iou_thresh: float = 0.5
    bg_iou_thresh: float = 0.5
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 100
    # Static NMS candidate pool after the score threshold.
    nms_pool: int = 4096


def postprocess_detections(
    class_logits: torch.Tensor,    # [B, P, C]
    box_deltas: torch.Tensor,      # [B, P, C*4]
    proposals: torch.Tensor,       # [B, P, 4]
    proposal_valid: torch.Tensor,  # [B, P]
    image_hw: torch.Tensor,        # [B, 2]
    cfg: BoxHeadConfig,
):
    """torchvision RoIHeads.postprocess_detections, batched.

    Returns fixed-size (boxes [B, D, 4], scores [B, D], labels [B, D],
    valid [B, D]).
    """
    B, P, C = class_logits.shape
    scores = torch.softmax(class_logits, dim=-1)
    boxes = decode_boxes(box_deltas.reshape(B, P, C, 4), proposals[:, :, None],
                         BOX_CODER_WEIGHTS)
    hw = image_hw.to(boxes.device).float()
    boxes = clip_boxes_to_image(boxes, hw[:, 0, None, None],
                                hw[:, 1, None, None])

    # Drop the background column; flatten (proposal, class) pairs.
    fg_scores = scores[:, :, 1:].reshape(B, -1)              # [B, P*(C-1)]
    fg_boxes = boxes[:, :, 1:].reshape(B, -1, 4)
    fg_labels = torch.arange(1, C, dtype=torch.int32,
                             device=scores.device).repeat(P)

    ok = fg_scores > cfg.score_thresh
    ok &= proposal_valid.repeat_interleave(C - 1, dim=1)
    # remove_small_boxes(min_size=1e-2)
    ok &= (fg_boxes[..., 2] - fg_boxes[..., 0]) >= 1e-2
    ok &= (fg_boxes[..., 3] - fg_boxes[..., 1]) >= 1e-2
    masked = torch.where(ok, fg_scores, torch.full_like(fg_scores, NEG_INF))

    # Static candidate pool for NMS (ties to the lowest index, as top_k).
    pool = min(cfg.nms_pool, masked.shape[1])
    top_scores, top_idx = torch.sort(masked, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :pool], top_idx[:, :pool]
    cand_boxes = torch.gather(fg_boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    keep, valid = batched_nms(cand_boxes, top_scores, fg_labels[top_idx],
                              cfg.nms_thresh, cfg.detections_per_img)
    sel = torch.gather(top_idx, 1, keep.long())
    out_boxes = torch.gather(fg_boxes, 1, sel[..., None].expand(-1, -1, 4))
    out_scores = torch.where(valid, torch.gather(fg_scores, 1, sel),
                             torch.zeros((), device=sel.device))
    out_labels = torch.where(valid, fg_labels[sel],
                             torch.zeros((), dtype=torch.int32,
                                         device=sel.device))
    return out_boxes, out_scores, out_labels, valid
