"""A synthetic COCO-format directory made from a seed, in the layout of
``get_coco``: ``{root}/{train,val}2017/*.jpg`` and
``{root}/annotations/instances_{train,val}2017.json``; or of
``get_coco_kp`` (``write_coco_kp``), with person-keypoint annotations.

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


# COCO's 17 person keypoints and their skeleton (person_keypoints_*.json).
KEYPOINT_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle")
SKELETON = [[16, 14], [14, 12], [17, 15], [15, 13], [12, 13], [6, 12],
            [7, 13], [6, 7], [6, 8], [7, 9], [8, 10], [9, 11], [2, 3],
            [1, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 7]]


def write_coco_kp(root: str, splits: Dict[str, Sequence[Tuple[int, int]]],
                  seed: int = 0, persons=(1, 4), box_frac=(0.2, 0.7),
                  invisible: float = 0.3, extras: bool = False) -> str:
    """A person-keypoint COCO directory in the layout of ``get_coco_kp``:
    ``{root}/{train,val}2017/*.jpg`` and
    ``{root}/annotations/person_keypoints_{train,val}2017.json``, one
    ``person`` category (id 1) with COCO's 17 keypoints. Each image holds
    ``persons`` = (min, max) people, each with a box of ``box_frac`` of
    the image's sides, a hexagon segmentation inside it, and 17 keypoints
    inside it, each unlabelled (visibility 0, at (0, 0)) with probability
    ``invisible``, else labelled 1 or 2. With ``extras`` the val split's
    first image also gets a crowd region (an uncompressed RLE, no
    keypoints), a person with no labelled keypoint, and one whose
    annotation has 5 keypoints; its last image has no one."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    cats = [{"id": 1, "name": "person", "supercategory": "person",
             "keypoints": list(KEYPOINT_NAMES), "skeleton": SKELETON}]
    for split, sizes in splits.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        images, anns = [], []
        for i, (h, w) in enumerate(sizes):
            arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            name = f"{i:012d}.jpg"
            Image.fromarray(arr).save(os.path.join(root, split, name))
            images.append({"id": i + 1, "file_name": name,
                           "height": h, "width": w})
            n = int(rng.integers(persons[0], persons[1] + 1))
            if extras and i == len(sizes) - 1:
                n = 0
            for _ in range(n):
                bw, bh = rng.uniform(*box_frac, 2) * (w, h)
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                kx = x + rng.uniform(0, bw, 17)
                ky = y + rng.uniform(0, bh, 17)
                v = np.where(rng.random(17) < invisible, 0,
                             rng.integers(1, 3, 17))
                kps = np.stack([np.where(v > 0, kx, 0.0),
                                np.where(v > 0, ky, 0.0), v], 1)
                t = np.arange(6) * np.pi / 3
                hexagon = np.stack([x + bw * (0.5 + 0.45 * np.cos(t)),
                                    y + bh * (0.5 + 0.45 * np.sin(t))], 1)
                anns.append({
                    "image_id": i + 1, "category_id": 1,
                    "bbox": [float(x), float(y), float(bw), float(bh)],
                    "area": float(0.6 * bw * bh), "iscrowd": 0,
                    "segmentation": [hexagon.ravel().round(2).tolist()],
                    "keypoints": kps.ravel().round(2).tolist(),
                    "num_keypoints": int((v > 0).sum())})
            if extras and i == 0:
                # A crowd region: column-major runs over the whole image.
                col = np.zeros(h, np.int64)
                col[h // 4: h // 2] = 1
                mask = np.zeros((h, w), np.uint8)
                mask[:, w // 4: w // 2] = col[:, None]
                flat = mask.reshape(-1, order="F")
                edges = np.flatnonzero(np.diff(flat)) + 1
                counts = np.diff(np.concatenate([[0], edges, [flat.size]]))
                anns.append({
                    "image_id": 1, "category_id": 1,
                    "bbox": [float(w // 4), float(h // 4),
                             float(w // 2 - w // 4), float(h // 2 - h // 4)],
                    "area": float(mask.sum()), "iscrowd": 1,
                    "segmentation": {"size": [h, w],
                                     "counts": counts.tolist()},
                    "keypoints": [0] * 51, "num_keypoints": 0})
                box = [5.0, 6.0, 0.3 * w, 0.4 * h]
                anns.append({
                    "image_id": 1, "category_id": 1, "bbox": box,
                    "area": box[2] * box[3], "iscrowd": 0,
                    "segmentation": [[5.0, 6.0, 5.0 + box[2], 6.0,
                                      5.0 + box[2], 6.0 + box[3]]],
                    "keypoints": [0] * 51, "num_keypoints": 0})
                anns.append({
                    "image_id": 1, "category_id": 1,
                    "bbox": [10.0, 12.0, 0.5 * w, 0.5 * h],
                    "area": 0.25 * w * h, "iscrowd": 0,
                    "segmentation": [[10.0, 12.0, 10.0 + 0.5 * w, 12.0,
                                      10.0 + 0.5 * w, 12.0 + 0.5 * h,
                                      10.0, 12.0 + 0.5 * h]],
                    "keypoints": [20.0, 22.0, 2] * 5, "num_keypoints": 5})
        for k, a in enumerate(anns, start=1):
            a["id"] = k
        with open(os.path.join(root, "annotations",
                               f"person_keypoints_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": cats}, f)
    return root
