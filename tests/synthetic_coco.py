"""A synthetic COCO-format directory made from a seed, in the layout of
``get_coco``: ``{root}/{train,val}2017/*.jpg`` and
``{root}/annotations/instances_{train,val}2017.json``.

Used by the CPU tests and by ``chip_smoke.py``; numpy and PIL only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np
from PIL import Image

# COCO val2017's commonest image sizes, (h, w).
COCO_SIZES = ((480, 640), (640, 480), (427, 640), (640, 427), (500, 375))


def write_coco(root: str, splits: Dict[str, Sequence[Tuple[int, int]]],
               seed: int = 0, n_cats: int = 90, boxes=(2, 6),
               box_frac=(0.05, 0.6), extras: bool = False) -> str:
    """Write one split per ``splits`` entry (name -> image sizes), with
    ``boxes`` = (min, max) random boxes per image over categories
    1..``n_cats``, each side ``box_frac`` (min, max) of the image's. With
    ``extras`` the val split also gets a crowd box and a degenerate box on
    its first image and an image with no box."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    cats = [{"id": c, "name": f"c{c}"} for c in range(1, n_cats + 1)]
    for split, sizes in splits.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        images, anns = [], []
        for i, (h, w) in enumerate(sizes):
            arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            name = f"{i:012d}.jpg"
            Image.fromarray(arr).save(os.path.join(root, split, name))
            images.append({"id": i + 1, "file_name": name,
                           "height": h, "width": w})
            n = int(rng.integers(boxes[0], boxes[1] + 1))
            if extras and i == len(sizes) - 1:
                n = 0
            for _ in range(n):
                bw, bh = rng.uniform(*box_frac, 2) * (w, h)
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                anns.append({"image_id": i + 1,
                             "category_id": int(rng.integers(1, n_cats + 1)),
                             "bbox": [float(x), float(y), float(bw), float(bh)],
                             "area": float(bw * bh), "iscrowd": 0})
            if extras and i == 0:
                anns.append({"image_id": 1, "category_id": 1,
                             "bbox": [5.0, 5.0, 40.0, 30.0], "area": 1200.0,
                             "iscrowd": 1})
                anns.append({"image_id": 1, "category_id": 2,
                             "bbox": [w + 5.0, 3.0, 10.0, 10.0],
                             "area": 100.0, "iscrowd": 0})
        for k, a in enumerate(anns, start=1):
            a["id"] = k
        with open(os.path.join(root, "annotations",
                               f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": cats}, f)
    return root
