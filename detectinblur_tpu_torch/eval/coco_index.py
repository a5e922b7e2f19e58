"""Minimal COCO annotation index (the parts of pycocotools.coco.COCO that
evaluation needs).

Copy of ``detectinblur_tpu/eval/coco_index.py``: image, annotation and
category indexes, ``get_ann_ids`` / ``load_anns`` lookups, and
``load_res`` for bbox, segmentation (RLE) and keypoint results. Mask RLE
ops live in ``eval/rle.py``.
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from detectinblur_tpu_torch.eval import rle as rle_mod

class COCOIndex:
    def __init__(self, annotations: Optional[dict | str] = None):
        self.dataset: Dict[str, Any] = {"images": [], "annotations": [], "categories": []}
        if annotations is not None:
            if isinstance(annotations, str):
                with open(annotations) as f:
                    annotations = json.load(f)
            self.dataset = annotations
        self._build()

    def _build(self):
        self.anns = {a["id"]: a for a in self.dataset.get("annotations", [])}
        self.imgs = {i["id"]: i for i in self.dataset.get("images", [])}
        self.cats = {c["id"]: c for c in self.dataset.get("categories", [])}
        self.img_to_anns = defaultdict(list)
        for a in self.dataset.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs.keys())

    def get_cat_ids(self) -> List[int]:
        return sorted(self.cats.keys())

    def get_ann_ids(self, img_ids: Iterable[int] = (), cat_ids: Iterable[int] = ()):
        img_ids = set(img_ids)
        cat_ids = set(cat_ids)
        anns = (
            [a for i in img_ids for a in self.img_to_anns[i]]
            if img_ids
            else self.dataset.get("annotations", [])
        )
        return [a["id"] for a in anns
                if not cat_ids or a["category_id"] in cat_ids]

    def load_anns(self, ids) -> List[dict]:
        return [self.anns[i] for i in ids]

    def load_res(self, results: List[dict]) -> "COCOIndex":
        """A results index from detection dicts ({image_id, category_id,
        score} with a bbox (xywh), an RLE segmentation or keypoints), with
        ids assigned and, where missing, the area: the box's, else the
        RLE's, and then the RLE's box; a keypoint result without a box gets
        its keypoints' tight box and that box's area (pycocotools
        loadRes)."""
        res = COCOIndex()
        res.dataset["images"] = [copy.deepcopy(i) for i in self.dataset["images"]]
        res.dataset["categories"] = copy.deepcopy(self.dataset.get("categories", []))
        anns = copy.deepcopy(results)
        for idx, a in enumerate(anns):
            if "bbox" in a and "area" not in a:
                bb = a["bbox"]
                a["area"] = bb[2] * bb[3]
            if "segmentation" in a and "area" not in a:
                a["area"] = float(rle_mod.area(a["segmentation"]))
                # JAX leaves the box out, and its matching then fails on
                # the missing key (ROADMAP, Queue 3).
                a.setdefault("bbox", rle_mod.toBbox(a["segmentation"]).tolist())
            if "keypoints" in a and "bbox" not in a:
                kp = np.asarray(a["keypoints"], np.float64)
                xs, ys = kp[0::3], kp[1::3]
                x0, x1 = float(xs.min()), float(xs.max())
                y0, y1 = float(ys.min()), float(ys.max())
                a["area"] = (x1 - x0) * (y1 - y0)
                a["bbox"] = [x0, y0, x1 - x0, y1 - y0]
            a.setdefault("iscrowd", 0)
            a["id"] = idx + 1
        res.dataset["annotations"] = anns
        res._build()
        return res
