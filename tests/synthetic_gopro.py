"""A synthetic GOPRO-layout tree made from a seed: ``{root}/{train,test}/
{sequence}/{blur,sharp}/NNNNNN.png``, each sharp frame with its DORS dump
(``_DORS.npy``: 80 coco80 classes, each [N, 5] x1, y1, x2, y2, score) and
its forward and backward optical flow (``_flow.npy``, ``_flow_bwd.npy``,
[H, W, 2] float32), as the natural-blur datasets read them.

Used by the CPU tests and by ``chip_smoke.py``; numpy and PIL only.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
from PIL import Image


def write_gopro(root: str, sequences: Sequence[Tuple[str, int]],
                hw: Tuple[int, int] = (96, 128), seed: int = 0,
                classes: Sequence[int] = (0, 1, 2, 3), boxes=(1, 4),
                box_frac=(0.1, 0.4), flow_std: float = 1.5) -> str:
    """Write one sequence of ``n`` frames per (split, n) of ``sequences``
    (``train`` or ``test``) at ``hw``: frames of a few moving squares on
    noise, so that averaging frames blurs them; ``boxes`` (min, max)
    scored boxes a frame over the coco80 ``classes``, each side
    ``box_frac`` (min, max) of the frame's, scores in 0.3-1 (some below
    the datasets' thresholds)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    for s, (split, n) in enumerate(sequences):
        base = np.clip(rng.normal(110, 30, (h, w, 3)), 0, 255)
        pos = rng.uniform(0, 0.6, (3, 2)) * (h, w)
        vel = rng.normal(0, 2.0, (3, 2))
        for i in range(n):
            frame = base.copy()
            for k in range(3):
                y, x = (pos[k] + i * vel[k]).astype(int)
                frame[max(y, 0):max(y + h // 5, 0),
                      max(x, 0):max(x + w // 5, 0)] = 40 + 70 * k
            for kind in ("blur", "sharp"):
                d = os.path.join(root, split, f"seq{s}", kind)
                os.makedirs(d, exist_ok=True)
                img = frame if kind == "sharp" else np.clip(
                    frame + rng.normal(0, 8, frame.shape), 0, 255)
                Image.fromarray(img.astype(np.uint8)).save(
                    os.path.join(d, f"{i:06d}.png"))
            stem = os.path.join(root, split, f"seq{s}", "sharp", f"{i:06d}")
            dors = np.empty(80, object)
            for c in range(80):
                dors[c] = np.zeros((0, 5), np.float32)
            for c in classes:
                m = int(rng.integers(boxes[0], boxes[1] + 1))
                rows = np.zeros((m, 5), np.float32)
                bw = rng.uniform(*box_frac, m) * w
                bh = rng.uniform(*box_frac, m) * h
                rows[:, 0] = rng.uniform(0, 1, m) * (w - bw)
                rows[:, 1] = rng.uniform(0, 1, m) * (h - bh)
                rows[:, 2] = rows[:, 0] + bw
                rows[:, 3] = rows[:, 1] + bh
                rows[:, 4] = rng.uniform(0.3, 1.0, m)
                dors[c] = rows
            with open(stem + "_DORS.npy", "wb") as f:
                np.save(f, dors, allow_pickle=True)
            for tag in ("_flow.npy", "_flow_bwd.npy"):
                np.save(stem + tag, rng.normal(0, flow_std, (h, w, 2))
                        .astype(np.float32))
    return root
