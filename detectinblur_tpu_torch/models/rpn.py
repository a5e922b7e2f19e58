"""Region Proposal Network (port of ``detectinblur_tpu/models/rpn.py``).

Fixed shapes as in the JAX version: per-level top-k, clip, small-box mask,
per-level NMS, post-NMS top-k, all over padded tensors with ``valid``
masks, and batched over the images (and levels) instead of vmapped. The
training pieces (anchor matching, the balanced sampler, the loss) are
batched the same way.

Random sampling cannot reproduce ``jax.random``'s streams: the sampler
draws its uniforms from a ``torch.Generator``, or takes them from the
caller (``draws``), which is how the tests feed it the JAX draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from detectinblur_tpu_torch.models.anchors import (
    ANCHOR_SIZES,
    ASPECT_RATIOS,
    grid_anchors,
)
from detectinblur_tpu_torch.models.resnet import Conv2d
from detectinblur_tpu_torch.ops.boxes import (
    box_iou,
    clip_boxes_to_image,
    decode_boxes,
    encode_boxes,
)
from detectinblur_tpu_torch.ops.nms import NEG_INF, grouped_nms_presorted
from detectinblur_tpu_torch.utils.device import to_device_async


class RPNHead(nn.Module):
    """3x3 conv + 1x1 objectness / box-delta heads, shared across levels.
    Emits float32, whatever the activation dtype: objectness feeds
    top-k/NMS ordering and the deltas feed box decode.

    The 3x3 conv maps ``in_channels`` to 256, as the JAX head does
    whatever its input: the single-map detectors feed it 1280 or 2048
    channels and 15 anchors a cell."""

    def __init__(self, in_channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = Conv2d(in_channels, 256, 3, padding=1)
        self.cls_logits = Conv2d(256, num_anchors, 1)
        self.bbox_pred = Conv2d(256, num_anchors * 4, 1)

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


def assign_targets_to_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                              gt_valid: torch.Tensor, fg_iou: float,
                              bg_iou: float):
    """torchvision Matcher(0.7, 0.3, allow_low_quality_matches=True),
    batched: ``anchors`` [A, 4], ``gt_boxes`` [B, G, 4] padded, ``gt_valid``
    [B, G] -> (labels [B, A] in {-1 ignore, 0 bg, 1 fg}, matches [B, A] gt
    index). Images without a valid GT get all-background labels."""
    iou = box_iou(gt_boxes, anchors)                     # [B, G, A]
    iou = torch.where(gt_valid[..., None], iou, torch.full_like(iou, -1.0))
    matched_vals = iou.amax(dim=1)
    matches = iou.argmax(dim=1)                          # first max, as JAX
    labels = torch.where(matched_vals >= fg_iou, 1, -1)
    labels = torch.where(matched_vals < bg_iou, 0, labels)
    # Low-quality matches: any anchor achieving a gt's best IoU is fg.
    best_per_gt = iou.amax(dim=2, keepdim=True)          # [B, G, 1]
    is_best = (iou == best_per_gt) & gt_valid[..., None] & (best_per_gt > 0)
    labels = torch.where(is_best.any(dim=1), 1, labels)
    return torch.where(gt_valid.any(dim=1, keepdim=True), labels, 0), matches


def balanced_sample(labels: torch.Tensor, batch_size: int,
                    positive_fraction: float,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """BalancedPositiveNegativeSampler over the last axis of ``labels``
    [..., A] in {-1, 0, 1} -> (pos_mask, neg_mask).

    Each of the two subsets is the ``n`` candidates with the smallest
    uniform keys, ties to the lower index (``jax.lax.top_k``'s order, here
    a stable sort). The keys are ``draws = (u_pos, u_neg)``, each shaped
    like ``labels``, or are drawn from ``generator``."""
    pos = labels == 1
    neg = labels == 0
    if draws is None:
        draws = tuple(torch.rand(labels.shape, generator=generator,
                                 device=labels.device) for _ in range(2))
    u_pos, u_neg = draws
    max_pos = int(batch_size * positive_fraction)
    A = labels.shape[-1]

    def pick(mask, cap, n_take, u):
        cap = min(cap, A)   # tiny anchor grids: A < budget
        r = torch.where(mask, u.to(labels.device), torch.inf)
        idx = torch.sort(r, dim=-1, stable=True)[1][..., :cap]
        first = torch.arange(cap, device=labels.device) < n_take[..., None]
        return torch.zeros_like(mask).scatter_(-1, idx, first) & mask

    num_pos = pos.sum(-1).clamp(max=max_pos)
    sel_pos = pick(pos, max_pos, num_pos, u_pos)
    num_neg = torch.minimum(neg.sum(-1), batch_size - num_pos)
    sel_neg = pick(neg, batch_size, num_neg, u_neg)
    return sel_pos, sel_neg


def smooth_l1(x: torch.Tensor, beta: float) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def rpn_loss(objectness: torch.Tensor, pred_deltas: torch.Tensor,
             anchors: torch.Tensor, gt_boxes: torch.Tensor,
             gt_valid: torch.Tensor, cfg: RPNConfig,
             generator: Optional[torch.Generator] = None, draws=None):
    """Per-image RPN loss sums, batched: ``objectness`` [B, A],
    ``pred_deltas`` [B, A, 4], ``anchors`` [A, 4], ``gt_boxes`` [B, G, 4]
    -> (box_l [B], obj_l [B], n [B] sampled count, at least 1). The caller
    sums over the batch and divides by the total count, as torchvision's
    compute_loss does. ``draws`` feeds ``balanced_sample``.

    Box regression touches only the <= 128 sampled positives, compacted
    into fixed slots (ties to the lower index). Slots that hold no positive
    are masked before ``smooth_l1``, so a degenerate target there (a padded
    GT box encodes to -inf) yields no NaN gradient; the loss is the JAX
    version's."""
    labels, matches = assign_targets_to_anchors(
        anchors, gt_boxes, gt_valid, cfg.fg_iou_thresh, cfg.bg_iou_thresh)
    sel_pos, sel_neg = balanced_sample(labels, cfg.batch_size_per_image,
                                       cfg.positive_fraction, generator, draws)
    sampled = sel_pos | sel_neg

    max_pos = min(int(cfg.batch_size_per_image * cfg.positive_fraction),
                  sel_pos.shape[-1])
    pos_idx = torch.sort(sel_pos.float(), dim=-1, descending=True,
                         stable=True)[1][:, :max_pos]             # [B, P]
    pos_ok = torch.gather(sel_pos, 1, pos_idx)
    gt_idx = torch.gather(matches, 1, pos_idx)
    targets = encode_boxes(
        torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4)),
        anchors[pos_idx], (1.0, 1.0, 1.0, 1.0))
    picked = torch.gather(pred_deltas, 1, pos_idx[..., None].expand(-1, -1, 4))
    diff = torch.where(pos_ok[..., None], picked - targets,
                       torch.zeros((), device=picked.device))
    box_l = smooth_l1(diff, 1.0 / 9).sum(dim=(1, 2))
    obj_t = labels.to(objectness.dtype)
    bce = (torch.maximum(objectness, torch.zeros_like(objectness))
           - objectness * obj_t
           + torch.log1p(torch.exp(-objectness.abs())))
    obj_l = torch.where(sampled, bce, torch.zeros_like(bce)).sum(dim=1)
    n = sampled.sum(dim=1).clamp(min=1)
    return box_l, obj_l, n


class RPNOutputs(NamedTuple):
    proposals: torch.Tensor       # [B, P, 4]
    proposal_valid: torch.Tensor  # [B, P]
    objectness: torch.Tensor      # [B, sum_A]
    pred_deltas: torch.Tensor     # [B, sum_A, 4]
    anchors: torch.Tensor         # [sum_A, 4]
    anchors_per_level: Tuple[int, ...]


def level_anchors(features: Sequence[torch.Tensor],
                  first_level_stride: int = 4,
                  anchor_sizes: Tuple[Tuple[float, ...], ...] = ANCHOR_SIZES,
                  anchor_ratios: Tuple[Tuple[float, ...], ...] = ASPECT_RATIOS):
    """(anchors [sum_A, 4] on the features' device, copied there without
    a host sync, anchors per level).
    The FPN detector's levels start at stride 4 with one size a level;
    a single-map detector passes its one level's stride and a one-level
    spec of every size (JAX ``run_rpn``'s ``anchor_sizes`` :264)."""
    feat_shapes = tuple((f.shape[1], f.shape[2]) for f in features)
    image_size = (int(features[0].shape[1] * first_level_stride),
                  int(features[0].shape[2] * first_level_stride))
    anchors_np = grid_anchors(feat_shapes, image_size, anchor_sizes,
                              anchor_ratios)
    anchors = np.concatenate(anchors_np, axis=0)
    return (to_device_async(anchors, features[0].device),
            tuple(a.shape[0] for a in anchors_np))


def run_rpn(head: RPNHead, features: Sequence[torch.Tensor],
            image_hw: torch.Tensor, cfg: RPNConfig = RPNConfig(),
            anchors=None, training: bool = False) -> RPNOutputs:
    """Run the RPN over a batch of NHWC levels: P2..P6, or a single-map
    detector's one level.

    ``training`` selects the train top-k sizes. Proposals are decoded from
    detached deltas and objectness (the JAX version's ``stop_gradient``);
    ``objectness`` and ``pred_deltas`` keep their graph for the loss.
    ``anchors`` may pass a cached ``level_anchors`` result for these
    features (a single-map detector passes its own stride and spec)."""
    logits, deltas = head(features)
    if anchors is None:
        anchors = level_anchors(features)
    anchors, anchors_per_level = anchors
    objectness = torch.cat(logits, dim=1)                 # [B, sum_A]
    pred_deltas = torch.cat(deltas, dim=1)                # [B, sum_A, 4]
    props = decode_boxes(pred_deltas.detach(), anchors[None],
                         (1.0, 1.0, 1.0, 1.0))
    pre_n = cfg.pre_nms_top_n_train if training else cfg.pre_nms_top_n_test
    post_n = cfg.post_nms_top_n_train if training else cfg.post_nms_top_n_test
    boxes, valid = filter_proposals(
        props, objectness.detach(), anchors_per_level, image_hw, pre_n,
        post_n, cfg.nms_thresh, cfg.min_size)
    return RPNOutputs(boxes, valid, objectness, pred_deltas, anchors,
                      anchors_per_level)
