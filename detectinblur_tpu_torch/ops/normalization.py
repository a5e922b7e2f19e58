"""Blur-conditional input normalization (``--use_custom_image_norm``).

Port of ``detectinblur_tpu/ops/normalization.py``: a blurred image is
normalized with the measured per-channel std of its (blur type, exposure)
bin, the mean staying ImageNet's. ``STD_TABLE`` holds the measured stds of
blurred COCO for the three training blur types x six exposure columns,
rescaled by 0.229/0.2384 as the reference does; column ``fraction_index +
1`` is used. Images that are not blurred, or whose ``param_index`` or
``fraction_index`` is negative (negligible exposure), keep the ImageNet
statistics.
"""

from __future__ import annotations

import numpy as np
import torch

CANONICAL_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
CANONICAL_STD = np.array([0.229, 0.224, 0.225], np.float32)

# Measured stds, rows = 6 exposure columns, cols = RGB.
_STD_P1 = np.array([
    [0.2384, 0.2334, 0.2370], [0.2337, 0.2288, 0.2325], [0.2270, 0.2221, 0.2261],
    [0.2209, 0.2161, 0.2203], [0.2127, 0.2082, 0.2126], [0.2087, 0.2043, 0.2088],
], np.float32)
_STD_P2 = np.array([
    [0.2384, 0.2334, 0.2370], [0.2337, 0.2287, 0.2325], [0.2267, 0.2218, 0.2258],
    [0.2184, 0.2137, 0.2180], [0.2048, 0.2006, 0.2051], [0.1950, 0.1911, 0.1957],
], np.float32)
_STD_P3 = np.array([
    [0.2384, 0.2334, 0.2370], [0.2337, 0.2287, 0.2325], [0.2266, 0.2217, 0.2258],
    [0.2182, 0.2136, 0.2178], [0.2012, 0.1972, 0.2017], [0.1824, 0.1790, 0.1838],
], np.float32)

STD_TABLE = np.stack([_STD_P1, _STD_P2, _STD_P3]) * (0.229 / 0.2384)  # [3, 6, 3]


def get_norm_params(blurring: torch.Tensor, param_index: torch.Tensor,
                    fraction_index: torch.Tensor):
    """Per-image (means [B, 3], stds [B, 3]) float32, on ``blurring``'s
    device."""
    device = blurring.device
    B = blurring.shape[0]
    means = torch.from_numpy(CANONICAL_MEAN).to(device).expand(B, 3)
    table = torch.from_numpy(STD_TABLE).to(device)
    p = param_index.to(device).long().clamp(0, 2)
    f = (fraction_index.to(device).long() + 1).clamp(0, 5)
    use = (blurring.to(device).bool() & (param_index.to(device) >= 0)
           & (fraction_index.to(device) >= 0))
    stds = torch.where(use[:, None], table[p, f],
                       torch.from_numpy(CANONICAL_STD).to(device)[None])
    return means.contiguous(), stds
