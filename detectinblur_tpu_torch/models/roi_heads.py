"""Fast R-CNN box head, roi sampling, loss and detection postprocess.

Port of ``detectinblur_tpu/models/roi_heads.py`` (``TwoMLPHead`` :31,
``FastRCNNPredictor`` :54, ``BoxHeadConfig`` :75,
``select_training_samples`` :88, ``fastrcnn_loss`` :144,
``postprocess_detections`` :173), batched over the images.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from detectinblur_tpu_torch.models.resnet import Linear
from detectinblur_tpu_torch.models.rpn import balanced_sample, smooth_l1
from detectinblur_tpu_torch.ops.boxes import (
    box_iou,
    clip_boxes_to_image,
    decode_boxes,
    encode_boxes,
)
from detectinblur_tpu_torch.ops.nms import NEG_INF, batched_nms

BOX_CODER_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


class TwoMLPHead(nn.Module):
    """fc6 -> relu -> fc7 -> relu over pooled rois flattened in torch CHW
    order (the reference's fc6 weights expect it, faster_rcnn.py:174)."""

    def __init__(self, in_channels: int = 256, resolution: int = 7,
                 representation_size: int = 1024):
        super().__init__()
        self.fc6 = Linear(in_channels * resolution * resolution,
                          representation_size)
        self.fc7 = Linear(representation_size, representation_size)

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
        self.cls_score = Linear(in_channels, num_classes)
        self.bbox_pred = Linear(in_channels, num_classes * 4)

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


def select_training_samples(proposals: torch.Tensor,
                            proposal_valid: torch.Tensor,
                            gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                            gt_valid: torch.Tensor, cfg: BoxHeadConfig,
                            generator: Optional[torch.Generator] = None,
                            draws=None):
    """torchvision RoIHeads.select_training_samples, batched.

    The GT boxes [B, G, 4] are appended to the proposals [B, P, 4], matched
    at IoU 0.5/0.5 without low-quality matches, and S =
    ``batch_size_per_image`` rois sampled at 25% foreground (``draws``
    feeds ``balanced_sample``, shaped [B, P+G]) and compacted into S slots,
    positives first, each group in index order (a stable sort). Returns
    (rois [B, S, 4], labels [B, S] (-1 in empty slots), reg_targets
    [B, S, 4], valid [B, S]). Nothing here carries a gradient."""
    all_boxes = torch.cat([proposals, gt_boxes], dim=1)
    all_valid = torch.cat([proposal_valid, gt_valid], dim=1)
    iou = box_iou(gt_boxes, all_boxes)                   # [B, G, P+G]
    keep = gt_valid[:, :, None] & all_valid[:, None, :]
    iou = torch.where(keep, iou, torch.full_like(iou, -1.0))
    matched_vals = iou.amax(dim=1)
    matches = iou.argmax(dim=1)

    fg = matched_vals >= cfg.fg_iou_thresh
    labels = torch.where(fg & all_valid, torch.gather(gt_labels, 1, matches), 0)
    match_tag = torch.where(all_valid, fg.long(), -1)
    any_gt = gt_valid.any(dim=1, keepdim=True)
    match_tag = torch.where(any_gt, match_tag, torch.where(all_valid, 0, -1))
    labels = torch.where(any_gt, labels, 0)

    sel_pos, sel_neg = balanced_sample(match_tag, cfg.batch_size_per_image,
                                       cfg.positive_fraction, generator, draws)
    sampled = sel_pos | sel_neg
    prio = torch.where(sel_pos, 0, torch.where(sel_neg, 1, 2))
    slots = torch.argsort(prio, dim=1, stable=True)[:, :cfg.batch_size_per_image]

    rois = torch.gather(all_boxes, 1, slots[..., None].expand(-1, -1, 4))
    roi_gt = torch.gather(matches, 1, slots)
    matched_gt = torch.gather(gt_boxes, 1, roi_gt[..., None].expand(-1, -1, 4))
    roi_valid = torch.gather(sampled, 1, slots)
    reg_targets = encode_boxes(matched_gt, rois, BOX_CODER_WEIGHTS)
    roi_labels = torch.where(roi_valid, torch.gather(labels, 1, slots), -1)
    return rois, roi_labels, reg_targets, roi_valid


def fastrcnn_loss(class_logits: torch.Tensor, box_deltas: torch.Tensor,
                  labels: torch.Tensor, reg_targets: torch.Tensor):
    """torchvision fastrcnn_loss sums per image, batched: CE over the
    sampled rois (``labels`` >= 0), smooth_l1 (beta 1/9) over the positives
    (``labels`` > 0). ``class_logits`` [B, S, C], ``box_deltas`` [B, S,
    C*4] -> (ce_sum [B], box_sum [B], n [B]); the caller normalizes over
    the batch. Non-positive slots are masked before ``smooth_l1`` (their
    targets may be degenerate), so they give no NaN gradient."""
    B, S, C = class_logits.shape
    valid = labels >= 0
    safe = labels.clamp(min=0).long()
    logp = torch.log_softmax(class_logits, dim=-1)
    ce = -torch.gather(logp, 2, safe[..., None])[..., 0]
    ce_sum = torch.where(valid, ce, torch.zeros_like(ce)).sum(dim=1)
    picked = torch.gather(box_deltas.reshape(B, S, C, 4), 2,
                          safe[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    diff = torch.where((labels > 0)[..., None], picked - reg_targets,
                       torch.zeros((), device=picked.device))
    box_sum = smooth_l1(diff, 1.0 / 9).sum(dim=-1).sum(dim=-1)
    return ce_sum, box_sum, valid.sum(dim=1)


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
