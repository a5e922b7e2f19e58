"""The reference's training step: the device blur, the PSF-driven GT
expansion, the four losses, the backward and SGD with momentum and weight
decay under the warm-up schedule, in float32 torch.

A frozen copy of what the port's ``train/engine.py::make_train_step`` and
``train/state.py`` compute: d = g + wd * p, buf = m * buf + d (buf = d at
the first step), p -= lr * buf, with the learning rate of step s
``base_lr * (warmup_factor * (1 - s / W) + s / W)`` for s < W = min(1000,
steps_per_epoch - 1), in float32 arithmetic.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from benchmark.reference import ops
from benchmark.reference.models import Detector


def lr_at(step: int, opt: dict) -> float:
    f32 = np.float32
    warm = min(1000, opt["steps_per_epoch"] - 1)
    lr = f32(opt["base_lr"])
    if step < warm:
        alpha = f32(step) / f32(warm)
        lr = lr * (f32(opt["warmup_factor"]) * (f32(1) - alpha) + alpha)
    return float(lr)


def trainable(model: Detector) -> Dict[str, torch.nn.Parameter]:
    """The parameters SGD updates: all but those under the
    configuration's ``frozen`` prefixes."""
    frozen = tuple(model.cfg.get("frozen", ()))
    return {n: p for n, p in model.named_parameters()
            if not n.startswith(frozen)}


def blur_expand(batch: dict, exact: bool):
    """(blurred images [B, H, W, 3], GT boxes grown by their PSFs)."""
    images = ops.blur(batch["images"].permute(0, 3, 1, 2), batch["psfs"],
                      exact).permute(0, 2, 3, 1)
    hw = torch.as_tensor(batch["hw"], device=images.device).float()
    gt = ops.expand_boxes_by_psf(batch["gt_boxes"], batch["psfs"],
                                 batch["blurring"], hw[:, 0], hw[:, 1])
    return images, gt


class Steps(NamedTuple):
    losses: List[Dict[str, float]]        # each step's four losses
    grad: Dict[str, torch.Tensor]         # the first step's gradient
    change: Dict[str, torch.Tensor]       # parameters after - before
    rois: List[torch.Tensor]              # each step's pooled rois


def sgd_steps(model: Detector, batches: List[dict], draws: list,
              bucket, opt: dict, exact: bool, keep=None) -> Steps:
    """Train ``model`` (loaded with the start weights) one step on each
    batch with its sampler keys ((rpn u_pos, u_neg), (roi u_pos, u_neg)).
    ``keep``, when given, trains on the first ``keep`` images of each
    batch alone (the losses are the mean over those)."""
    params = trainable(model)
    for n, p in model.named_parameters():
        p.requires_grad_(n in params)
    start = {n: p.detach().clone() for n, p in params.items()}
    bufs = {}
    losses, grad, rois_seen = [], None, []
    model.backbone.train(True)
    for step, (batch, dr) in enumerate(zip(batches, draws)):
        if keep is not None:
            batch = {k: v[:keep] for k, v in batch.items()}
            dr = tuple(tuple(u[:keep] for u in pair) for pair in dr)
        images, gt = blur_expand(batch, exact)
        parts, rois = model.loss(images, np.asarray(batch["hw"]), gt,
                                 batch["gt_labels"], batch["gt_valid"],
                                 bucket, dr)
        total = sum(parts.values())
        for p in params.values():
            p.grad = None
        total.backward()
        lr = lr_at(step, opt)
        with torch.no_grad():
            for n, p in params.items():
                d = p.grad + opt["weight_decay"] * p
                bufs[n] = d.clone() if n not in bufs else (
                    opt["momentum"] * bufs[n] + d)
                p -= lr * bufs[n]
        if grad is None:
            grad = {n: p.grad.detach().clone() for n, p in params.items()}
        losses.append({k: float(v.detach()) for k, v in parts.items()})
        rois_seen.append(rois.detach())
    model.backbone.train(False)
    change = {n: (p.detach() - start[n]) for n, p in params.items()}
    return Steps(losses, grad, change, rois_seen)
