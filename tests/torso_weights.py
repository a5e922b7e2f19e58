"""Numerically sane torchvision ImageNet classifier dicts for the
single-map detectors' torsos (``--model mobile_net|resnet_50``), from
``tests/synthetic_torch.py``'s layouts and a seed. numpy only: the CPU
tests and ``chip_smoke.py`` share them."""

from __future__ import annotations

import numpy as np

from synthetic_torch import (
    synthetic_mobilenet_v2_state_dict,
    synthetic_resnet_state_dict,
)


def he_scaled(sd, seed=5):
    """A torchvision classifier dict made numerically sane: convolutions
    He-scaled, BatchNorm gammas in 0.8-1.2 (x0.2 on a ResNet block's last
    BatchNorm, so that the residual stream stays near unit scale), small
    betas and means, running variances in 0.8-1.2."""
    rng = np.random.default_rng(seed)
    last = "bn3.weight" if any(k.endswith("bn3.weight") for k in sd) \
        else "bn2.weight"
    out = {}
    for k, v in sd.items():
        if v.ndim == 4:
            v = v * np.float32(np.sqrt(2.0 / np.prod(v.shape[1:])))
        elif k.endswith("running_var"):
            v = rng.uniform(0.8, 1.2, v.shape)
        elif k.endswith(("running_mean", ".bias")):
            v = 0.05 * v
        elif k.endswith(".weight") and v.ndim == 1:
            v = rng.uniform(0.8, 1.2, v.shape) * (
                0.2 if k.startswith("layer") and k.endswith(last) else 1.0)
        out[k] = np.asarray(v, np.float32)
    return out


def mobilenet_sd(seed=0):
    """torchvision ``mobilenet_v2`` layout, He-scaled."""
    return he_scaled(synthetic_mobilenet_v2_state_dict(seed=seed))


def resnet_sd(arch, seed=1):
    """torchvision resnet classifier layout (``arch``), He-scaled."""
    return he_scaled(synthetic_resnet_state_dict(arch, seed=seed))
