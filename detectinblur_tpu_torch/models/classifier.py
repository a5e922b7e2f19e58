"""The blur-type estimator: a resnet18 classifier, and its label maps.

Port of ``detectinblur_tpu/models/classifier.py``: ``ResNetClassifier``
(:22) is the torchvision resnet18 trunk with ``AdaptiveBatchNorm``s,
global average pooling and a fresh ``fc`` with torch's Linear init, to 16
classes (no blur + 3 blur types x 5 exposures) or 4 for LEHE (no blur or
low exposure, then the three types at high exposure). The label maps
(:42-74) derive a class from the blur struct and a specialist index from
a class or, for the oracle, from the blur struct.

Module names mirror the JAX tree (``body.layer1_0.conv1``, ``fc``) so
``utils/convert.py`` maps it key for key. The BatchNorm mode is the
module's (``train`` while the estimator trains, ``eval`` in the
ensemble); ``models.batchnorm.bn_mode`` switches it for a call. As for the
detector, the running statistics of ``train`` mode are written only while
the module is in training mode (the train step holds it there).
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from detectinblur_tpu_torch.models.batchnorm import AdaptiveBatchNorm
from detectinblur_tpu_torch.models.resnet import (
    Linear,
    ResNet,
    reset_trunk,
    set_compute_dtype,
)
from detectinblur_tpu_torch.utils.device import (
    DEFAULT_PRECISION,
    act_dtype,
    resolve_device,
    set_fp32_math,
)


class ResNetClassifier(nn.Module):
    """images NHWC [B, H, W, 3] (normalized) -> logits [B, num_classes]
    float32. The trunk's convolutions compute in the precision's
    activation dtype; its BatchNorms, the pool and ``fc`` in float32, as
    in JAX. Built on ``device`` (CUDA unless the caller asks for another),
    initialised from a generator seeded with ``seed``."""

    def __init__(self, arch: str = "resnet18", num_classes: int = 16,
                 bn_mode: str = "train", precision: str = DEFAULT_PRECISION,
                 device=None, seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
        self.act_dtype = act_dtype(precision)
        device = resolve_device(device)
        with torch.device("meta" if device.type == "meta" else "cpu"):
            self.body = ResNet(arch, functools.partial(AdaptiveBatchNorm,
                                                       mode=bn_mode))
            self.fc = Linear(self.body.out_channels[-1], num_classes)
        set_compute_dtype(self.body, self.act_dtype)
        if device.type != "meta":
            self.reset_parameters(torch.Generator().manual_seed(seed))
        if device.type == "cuda":
            set_fp32_math()
        self.to(device=device, memory_format=torch.channels_last)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_trunk(self.body, generator)
        # torch nn.Linear default init, drawn from the generator.
        bound = 1.0 / self.fc.in_features ** 0.5
        nn.init.kaiming_uniform_(self.fc.weight, a=5 ** 0.5,
                                 generator=generator)
        nn.init.uniform_(self.fc.bias, -bound, bound, generator=generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.act_dtype).permute(0, 3, 1, 2)  # channels-last
        feats = self.body(x)[-1]
        return self.fc(feats.float().mean(dim=(2, 3)))


def estimator_label(blurring, param_index, fraction_index) -> torch.Tensor:
    """16-class label: 0 = no blur (or negligible exposure), else
    param_index * 5 + fraction_index + 1."""
    on = blurring.bool() & (param_index >= 0) & (fraction_index >= 0)
    return torch.where(on, param_index * 5 + fraction_index + 1,
                       0).to(torch.int64)


def estimator_label_lehe(blurring, param_index, fraction_index,
                         est_label=None) -> torch.Tensor:
    """LEHE 4-class label: 0 = none or low exposure, 1..3 = blur type
    P1..P3 at high exposure (fraction_index 3 or 4). A stored label
    (``est_label`` >= 0) wins over the derived one."""
    on = blurring.bool() & (param_index >= 0) & (fraction_index >= 3)
    lab = torch.where(on, param_index + 1, 0)
    if est_label is not None:
        lab = torch.where(est_label >= 0, est_label, lab)
    return lab.to(torch.int64)


def estimator_to_model_index_16(pred_class: torch.Tensor) -> torch.Tensor:
    """16-class prediction -> specialist index: class 0 -> model 0 (the
    clean specialist), else the blur type's specialist param_index + 1."""
    param = torch.div(pred_class - 1, 5, rounding_mode="floor")
    return torch.where(pred_class == 0, 0, param + 1).to(torch.int64)


def model_index_oracle(blurring, param_index, fraction_index) -> torch.Tensor:
    """Specialist index from the true blur struct: clean or negligible
    exposure -> model 0, else param_index + 1."""
    on = blurring.bool() & (param_index >= 0) & (fraction_index >= 0)
    return torch.where(on, param_index + 1, 0).to(torch.int64)
