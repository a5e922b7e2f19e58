"""Anchor generation matching torchvision's AnchorGenerator.

A copy of ``detectinblur_tpu/models/anchors.py`` (numpy only), kept here
so that the port imports nothing of the JAX package. The reference RPN
uses 5 levels x (1 size, 3 aspect ratios).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

ANCHOR_SIZES = ((32,), (64,), (128,), (256,), (512,))
ASPECT_RATIOS = ((0.5, 1.0, 2.0),) * 5


def cell_anchors(sizes: Sequence[float], ratios: Sequence[float]) -> np.ndarray:
    """Zero-centered base anchors, rounded, torchvision layout [A, 4]."""
    sizes = np.asarray(sizes, np.float32)
    ratios = np.asarray(ratios, np.float32)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    ws = (w_ratios[:, None] * sizes[None, :]).reshape(-1)
    hs = (h_ratios[:, None] * sizes[None, :]).reshape(-1)
    base = np.stack([-ws, -hs, ws, hs], axis=1) / 2.0
    return np.round(base).astype(np.float32)


@functools.lru_cache(maxsize=64)
def grid_anchors(
    feature_shapes: Tuple[Tuple[int, int], ...],
    image_size: Tuple[int, int],
    sizes: Tuple[Tuple[float, ...], ...] = ANCHOR_SIZES,
    ratios: Tuple[Tuple[float, ...], ...] = ASPECT_RATIOS,
) -> Tuple[np.ndarray, ...]:
    """Per-level anchors [H*W*A, 4] for the given feature shapes.

    Strides are image_size // feature_size per torchvision. Anchor ordering
    is (y, x, anchor) fastest-last, matching the head's NHWC flatten.
    The cache hands the same arrays to every caller: treat them as
    read-only.
    """
    out = []
    for lvl, (fh, fw) in enumerate(feature_shapes):
        base = cell_anchors(sizes[lvl], ratios[lvl])
        stride_y = image_size[0] // fh
        stride_x = image_size[1] // fw
        shifts_x = np.arange(fw, dtype=np.float32) * stride_x
        shifts_y = np.arange(fh, dtype=np.float32) * stride_y
        sy, sx = np.meshgrid(shifts_y, shifts_x, indexing="ij")
        shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
        anchors = (shifts + base[None]).reshape(-1, 4)
        out.append(anchors.astype(np.float32))
    return tuple(out)
