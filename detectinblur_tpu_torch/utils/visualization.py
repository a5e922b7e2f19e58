"""Detection overlays for ``cli.evaluate --image_output_dir``.

Port of ``detectinblur_tpu/utils/visualization.py``: each box drawn in
its class's colour (``unique_color``), two pixels wide, with
``{label}:{score:.2f}`` at its top-left corner, for the valid
detections scoring at least 0.5; written as ``det_{image_id}.png``.

A uint8 image is drawn as it is and a float image in [0, 1] is scaled by
255. JAX scales every image by 255 after clipping it to [0, 1], so the
uint8 canvases its eval loop hands it come out binarized, every pixel
but 0 turned to 255 (ROADMAP, Queue 3).
"""

from __future__ import annotations

import colorsys
import os
from typing import Optional

import numpy as np
from PIL import Image, ImageDraw


def unique_color(tag: int, hue_step: float = 0.05):
    """Stable per-class colour (the reference's create_unique_color_float)."""
    h = (tag * hue_step) % 1.0
    v = 1.0 - (int(tag * hue_step) % 4) / 5.0
    r, g, b = colorsys.hsv_to_rgb(h, 1.0, v)
    return int(r * 255), int(g * 255), int(b * 255)


def overlay_boxes(
    image: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    scores: Optional[np.ndarray] = None,
    valid: Optional[np.ndarray] = None,
    score_thresh: float = 0.5,
) -> Image.Image:
    if image.dtype != np.uint8:
        # A float image in [0, 1], clipped, scaled and truncated as JAX's.
        image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    img = Image.fromarray(np.ascontiguousarray(image))
    draw = ImageDraw.Draw(img)
    for i, b in enumerate(boxes):
        if valid is not None and not valid[i]:
            continue
        if scores is not None and scores[i] < score_thresh:
            continue
        color = unique_color(int(labels[i]))
        draw.rectangle([float(b[0]), float(b[1]), float(b[2]), float(b[3])],
                       outline=color, width=2)
        tag = f"{int(labels[i])}" + (f":{scores[i]:.2f}" if scores is not None else "")
        draw.text((float(b[0]) + 2, float(b[1]) + 2), tag, fill=color)
    return img


def dump_detections(output_dir: str, image_id: int, image: np.ndarray,
                    dets, index: int = 0) -> str:
    """Draw image ``index`` of a ``Detections`` batch on ``image`` and
    save it as ``{output_dir}/det_{image_id}.png``; returns the path."""
    os.makedirs(output_dir, exist_ok=True)
    boxes, scores, labels, valid = (t[index].cpu().numpy() for t in dets)
    img = overlay_boxes(image, boxes, labels, scores, valid)
    path = os.path.join(output_dir, f"det_{image_id}.png")
    img.save(path)
    return path
