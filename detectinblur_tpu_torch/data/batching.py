"""Static model buckets for a batch (host side, numpy only).

Copies of ``resized_hw_np`` and ``model_bucket_for_batch`` from
``detectinblur_tpu/data/batching.py:51,59``; the rest of that module (the
BlurBatch assembly) is training and loader code and is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def resized_hw_np(h: int, w: int, min_size=800, max_size=1333) -> Tuple[int, int]:
    """torchvision resize semantics: scale the min side to ``min_size``
    unless that pushes the max side past ``max_size``; output dims floor
    like interpolate(recompute_scale_factor)."""
    scale = min(min_size / min(h, w), max_size / max(h, w))
    return int(np.floor(h * scale)), int(np.floor(w * scale))


def model_bucket_for_batch(hw, min_size=800, max_size=1333,
                           divisor=64) -> Tuple[int, int]:
    """Static model bucket for one batch: the max resized extent over the
    batch's valid sizes, rounded up to ``divisor``."""
    hw = np.asarray(hw)
    rh, rw = zip(*(resized_hw_np(int(h), int(w), min_size, max_size)
                   for h, w in hw))
    Ho = int(np.ceil(max(rh) / divisor) * divisor)
    Wo = int(np.ceil(max(rw) / divisor) * divisor)
    return Ho, Wo
