"""Train state: SGD with momentum, warmup + MultiStep LR, frozen stages.

Port of ``detectinblur_tpu/train/state.py``: the reference recipe of SGD
with momentum 0.9 and weight decay 1e-4, MultiStepLR at epochs [16, 22]
with gamma 0.1, and a linear warmup from 1/1000 over the first
min(1000, steps_per_epoch - 1) iterations.

``torch.optim.SGD`` (dampening 0, no Nesterov) is the update of
``optax.add_decayed_weights`` + ``optax.sgd(momentum)``: d = g + wd * p,
buf = m * buf + d (buf = d at the first step, where optax's trace starts
from zeros), p -= lr * buf. The frozen parameters (``_freeze_mask``) get
``requires_grad=False`` and stay out of the optimizer, which is what
optax's ``set_to_zero`` branch does to them. The learning rate of each
step is set from ``make_lr_schedule`` by the train step.

JAX's state is immutable; here the step updates the model's parameters
and the optimizer's momentum in place.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


class TrainState(NamedTuple):
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def make_lr_schedule(base_lr: float, steps_per_epoch: int,
                     milestones: Sequence[int] = (16, 22), gamma: float = 0.1,
                     warmup_factor: float = 1.0 / 1000,
                     warmup_iters: Optional[int] = None
                     ) -> Callable[[int], float]:
    """step -> learning rate, in float32 arithmetic as the JAX schedule."""
    if warmup_iters is None:
        warmup_iters = (min(1000, steps_per_epoch - 1)
                        if steps_per_epoch > 1 else 0)
    boundaries = [m * steps_per_epoch for m in milestones]
    f32 = np.float32

    def schedule(step: int) -> float:
        decays = sum(step >= b for b in boundaries)
        lr = f32(base_lr) * f32(gamma) ** f32(decays)
        if step < warmup_iters:
            alpha = f32(step) / f32(warmup_iters)
            lr = lr * (f32(warmup_factor) * (f32(1) - alpha) + alpha)
        return float(lr)

    return schedule


def _freeze_mask(model: nn.Module, trainable_backbone_layers: int = 3
                 ) -> Dict[str, bool]:
    """Parameter name -> trainable. With 3 trainable stages (torchvision's
    ``trainable_backbone_layers``) the stem (conv1, bn1) and layer1 are
    frozen; layer2..4, the FPN and the heads train. The BatchNorm affines
    of the body stay frozen in every stage, as JAX's mask keeps them
    (:70): they are parameters of an ``AdaptiveBatchNorm`` (the
    FrozenBatchNorm keeps them as buffers). As JAX's, the mask looks only
    under ``backbone.body``: a single-map detector's torso
    (``backbone.*``) trains whole, its BatchNorm affines included."""
    frozen = ["conv1", "bn1"] if trainable_backbone_layers < 5 else []
    frozen += [f"layer{i}" for i in range(1, 5 - trainable_backbone_layers)]
    mask = {}
    for name, _ in model.named_parameters():
        keys = name.split(".")
        body = keys[:2] == ["backbone", "body"]
        mod = keys[2] if body else ""
        norm = body and any(k.startswith(("bn", "downsample_1"))
                            for k in keys[2:])
        mask[name] = not (norm or mod in frozen
                          or mod.split("_")[0] in frozen)
    return mask


def make_optimizer(model: nn.Module, base_lr: float = 0.04,
                   steps_per_epoch: int = 1000, momentum: float = 0.9,
                   weight_decay: float = 1e-4,
                   milestones: Sequence[int] = (16, 22), gamma: float = 0.1,
                   trainable_backbone_layers: int = 3
                   ) -> Tuple[torch.optim.SGD, Callable[[int], float]]:
    """(SGD over the trainable parameters, lr schedule). Freezes the
    other parameters of ``model`` (``requires_grad=False``)."""
    schedule = make_lr_schedule(base_lr, steps_per_epoch, milestones, gamma)
    mask = _freeze_mask(model, trainable_backbone_layers)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    optimizer = torch.optim.SGD(params, lr=schedule(0), momentum=momentum,
                                weight_decay=weight_decay)
    return optimizer, schedule


def create_train_state(model: nn.Module,
                       optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(0, model, optimizer)
