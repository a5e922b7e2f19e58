"""Region Proposal Network, inference branch (port of ``detectinblur_tpu/models/rpn.py``).

Fixed shapes as in the JAX version: per-level top-k, clip, small-box mask,
per-level NMS, post-NMS top-k, all over padded tensors with ``valid``
masks, and batched over the images (and levels) instead of vmapped. The
anchor assignment, sampling and loss are training code and are not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from detectinblur_tpu_torch.models.anchors import grid_anchors
from detectinblur_tpu_torch.ops.boxes import clip_boxes_to_image, decode_boxes
from detectinblur_tpu_torch.ops.nms import NEG_INF, grouped_nms_presorted


class RPNHead(nn.Module):
    """3x3 conv + 1x1 objectness / box-delta heads, shared across levels.
    Emits float32, whatever the activation dtype: objectness feeds
    top-k/NMS ordering and the deltas feed box decode."""

    def __init__(self, in_channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(in_channels, num_anchors * 4, 1)

    def forward(self, features: Sequence[torch.Tensor]):
        """features: levels NHWC [B, H, W, C] -> (logits [B, H*W*A],
        deltas [B, H*W*A, 4]) per level, in (y, x, anchor) order."""
        logits, deltas = [], []
        for f in features:
            t = F.relu(self.conv(f.permute(0, 3, 1, 2)))
            B = t.shape[0]
            logits.append(self.cls_logits(t).float()
                          .permute(0, 2, 3, 1).reshape(B, -1))
            deltas.append(self.bbox_pred(t).float()
                          .permute(0, 2, 3, 1).reshape(B, -1, 4))
        return logits, deltas

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # torchvision RPNHead init: every conv N(0, 0.01), bias 0.
        for m in (self.conv, self.cls_logits, self.bbox_pred):
            nn.init.normal_(m.weight, std=0.01, generator=generator)
            nn.init.zeros_(m.bias)


class RPNConfig(NamedTuple):
    pre_nms_top_n_train: int = 2000
    pre_nms_top_n_test: int = 1000
    post_nms_top_n_train: int = 2000
    post_nms_top_n_test: int = 1000
    nms_thresh: float = 0.7
    fg_iou_thresh: float = 0.7
    bg_iou_thresh: float = 0.3
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5
    min_size: float = 1e-3


def filter_proposals(
    proposals: torch.Tensor,     # [B, sum_A, 4] decoded
    objectness: torch.Tensor,    # [B, sum_A]
    anchors_per_level: Tuple[int, ...],
    image_hw: torch.Tensor,      # [B, 2] valid image sizes
    pre_nms_top_n: int,
    post_nms_top_n: int,
    nms_thresh: float,
    min_size: float,
):
    """torchvision RegionProposalNetwork.filter_proposals, batched.

    Levels never suppress each other, so NMS runs per (image, level) group
    over the level's top-k (a stable descending sort: ties to the lowest
    index, as ``jax.lax.top_k``). Returns (boxes [B, post_nms_top_n, 4],
    valid [B, post_nms_top_n]).
    """
    B = objectness.shape[0]
    kmax = max(min(pre_nms_top_n, n) for n in anchors_per_level)
    sel_scores, sel_boxes = [], []
    start = 0
    for n in anchors_per_level:
        k = min(pre_nms_top_n, n)
        sc = objectness[:, start:start + n]
        top_sc, top_idx = torch.sort(sc, dim=1, descending=True, stable=True)
        top_sc, top_idx = top_sc[:, :k], top_idx[:, :k]
        if k < kmax:   # padding tail keeps the descending-score precondition
            top_sc = torch.cat([top_sc, top_sc.new_full((B, kmax - k),
                                                        NEG_INF)], dim=1)
            top_idx = torch.cat([top_idx, top_idx.new_zeros(B, kmax - k)],
                                dim=1)
        sel_scores.append(top_sc)
        bx = proposals[:, start:start + n]
        sel_boxes.append(torch.gather(bx, 1, top_idx[..., None].expand(-1, -1, 4)))
        start += n

    scores = torch.stack(sel_scores, dim=1)              # [B, L, kmax]
    boxes = torch.stack(sel_boxes, dim=1)                # [B, L, kmax, 4]
    hw = image_hw.to(boxes.device).float()
    boxes = clip_boxes_to_image(boxes, hw[:, 0, None, None],
                                hw[:, 1, None, None])

    # Remove small boxes (min_size 1e-3): mask scores instead of filtering.
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    keep = (ws >= min_size) & (hs >= min_size)
    scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))

    idxs, valid = grouped_nms_presorted(boxes, scores, nms_thresh,
                                        post_nms_top_n)
    flat = boxes.reshape(B, -1, 4)
    out = torch.gather(flat, 1, idxs.long()[..., None].expand(-1, -1, 4))
    return out, valid


class RPNOutputs(NamedTuple):
    proposals: torch.Tensor       # [B, P, 4]
    proposal_valid: torch.Tensor  # [B, P]
    objectness: torch.Tensor      # [B, sum_A]
    pred_deltas: torch.Tensor     # [B, sum_A, 4]
    anchors: torch.Tensor         # [sum_A, 4]
    anchors_per_level: Tuple[int, ...]


def level_anchors(features: Sequence[torch.Tensor],
                  first_level_stride: int = 4):
    """(anchors [sum_A, 4] on the features' device, anchors per level)."""
    feat_shapes = tuple((f.shape[1], f.shape[2]) for f in features)
    image_size = (int(features[0].shape[1] * first_level_stride),
                  int(features[0].shape[2] * first_level_stride))
    anchors_np = grid_anchors(feat_shapes, image_size)
    anchors = torch.from_numpy(np.concatenate(anchors_np, axis=0))
    return (anchors.to(features[0].device),
            tuple(a.shape[0] for a in anchors_np))


def run_rpn(head: RPNHead, features: Sequence[torch.Tensor],
            image_hw: torch.Tensor, cfg: RPNConfig = RPNConfig(),
            anchors=None) -> RPNOutputs:
    """Run the RPN (inference) over a batch of NHWC levels P2..P6.

    ``anchors`` may pass a cached ``level_anchors(features)`` result."""
    logits, deltas = head(features)
    if anchors is None:
        anchors = level_anchors(features)
    anchors, anchors_per_level = anchors
    objectness = torch.cat(logits, dim=1)                 # [B, sum_A]
    pred_deltas = torch.cat(deltas, dim=1)                # [B, sum_A, 4]
    props = decode_boxes(pred_deltas, anchors[None], (1.0, 1.0, 1.0, 1.0))
    boxes, valid = filter_proposals(
        props, objectness, anchors_per_level, image_hw,
        cfg.pre_nms_top_n_test, cfg.post_nms_top_n_test, cfg.nms_thresh,
        cfg.min_size)
    return RPNOutputs(boxes, valid, objectness, pred_deltas, anchors,
                      anchors_per_level)
