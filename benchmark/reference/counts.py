"""What a call or a step has to compute and move, counted on the
reference at a cell's shapes, never on the program: the FLOPs of its
products and convolutions, and the bytes of the RoIAlign kernels.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over the
reference detector on the ``meta`` device: shapes only, nothing computed.
The RoIAlign bounds are the arithmetic of ``chip_smoke.py``'s
``roi_align_bound`` / ``roi_align_bwd_bound`` and ``_touched``, rewritten
to count from the rois and the feature-map shapes alone: every output
element written once and every feature cell that a sample corner needs
(a nonzero bilinear weight) read once; for the backward, the cotangent
read once and every cell touched by a roi with a nonzero cotangent read
and written once in float32. No table of the program's own layout is
counted.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import ops
from benchmark.reference.models import Detector
from benchmark.reference.train import trainable

ACT_BYTES = {"default": 2, "highest": 4}


def level_shapes(cfg: dict, bucket) -> Tuple[Tuple[int, int], ...]:
    """The (H, W) of each feature level at the model bucket (meta run)."""
    with torch.device("meta"):
        model = Detector(cfg)
        feats = model.features(torch.empty(1, *bucket, 3))
    return tuple((int(f.shape[1]), int(f.shape[2])) for f in feats)


def anchor_count(cfg: dict, bucket) -> int:
    a = cfg["anchors"]
    per_cell = len(a["sizes"][0]) * len(a["ratios"][0])
    return sum(h * w for h, w in level_shapes(cfg, bucket)) * per_cell


def step_flops(cfg: dict, batch: int, bucket, train: bool) -> float:
    """FLOPs of the products and convolutions of one ``predict`` call
    (``train`` False: the test-time proposals through the box head) or
    one training step (forward at the sampled rois, losses' inputs, and
    the backward of what trains) of ``batch`` images in ``bucket``."""
    box = cfg["box"]
    C = channels_of(cfg)
    rois = (box["batch_size_per_image"] if train
            else cfg["rpn"]["post_nms_top_n_test"])
    with torch.device("meta"):
        model = Detector(cfg)
    params = trainable(model)
    for n, p in model.named_parameters():
        p.requires_grad_(train and n in params)
    model.backbone.train(train)
    x = torch.empty(batch, *bucket, 3, device="meta")
    pooled = torch.empty(batch, rois, box["resolution"], box["resolution"], C,
                         device="meta", requires_grad=train)
    with FlopCounterMode(display=False) as counter:
        feats = model.features(x)
        logits, deltas = model.rpn_head(feats)
        cls, reg = model.head(pooled)
        if train:
            (logits.sum() + deltas.sum() + cls.sum() + reg.sum()).backward()
    return float(counter.get_total_flops())


def _corners(rois: torch.Tensor, shapes, spatial_scale):
    """(rows [N, S, S, 2, 2] of each sample corner in the levels stacked
    image-major, nonzero-weight mask) for [B, R, 4] rois."""
    B, R = rois.shape[:2]
    level, y, x = ops.roi_samples(rois.reshape(-1, 4), shapes, spatial_scale)
    rows, w = ops.sample_rows(level, y, x, R,
                              [(B, h, w_) for h, w_ in shapes])
    return rows, w != 0


def roi_align_fwd_bytes(rois: torch.Tensor, shapes, channels: int,
                        elem: int, spatial_scale=None) -> Tuple[int, int]:
    """(bytes, FLOPs) the forward needs for [B, R, 4] ``rois`` (every
    slot, as the kernel pools every slot) on levels ``shapes``: outputs
    written once, touched cells read once; 16 multiply-adds an output."""
    N = rois.shape[0] * rois.shape[1]
    rows, need = _corners(rois, shapes, spatial_scale)
    cells = torch.unique(rows[need]).numel()
    return (N * 49 * channels * elem + cells * channels * elem,
            N * 49 * channels * 16 * 2)


def roi_align_bwd_bytes(rois: torch.Tensor, active: torch.Tensor, shapes,
                        channels: int, elem: int,
                        spatial_scale=None) -> Tuple[int, int]:
    """(bytes, FLOPs) the backward kernel needs: the cotangent of every
    slot read once in ``elem`` bytes, and every cell touched by an
    ``active`` roi (nonzero cotangent) read and written once in float32;
    a multiply-add per channel of each nonzero corner update."""
    N = rois.shape[0] * rois.shape[1]
    rows, need = _corners(rois, shapes, spatial_scale)
    need = need & active.reshape(-1)[:, None, None, None, None]
    cells = torch.unique(rows[need]).numel()
    return (N * 49 * channels * elem + cells * channels * 4 * 2,
            int(need.sum()) * channels * 2)


def channels_of(cfg: dict) -> int:
    bb = cfg["backbone"]
    return bb.get("fpn_channels", bb.get("out_channels"))


def pooled_shapes(cfg: dict, bucket) -> Sequence[Tuple[int, int]]:
    return level_shapes(cfg, bucket)[:cfg["roi_align"]["levels"]]


def spatial_scale(cfg: dict) -> Optional[float]:
    return cfg["roi_align"].get("spatial_scale")
