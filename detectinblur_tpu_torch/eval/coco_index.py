"""Minimal COCO annotation index (the parts of pycocotools.coco.COCO that
bbox evaluation needs).

Copy of ``detectinblur_tpu/eval/coco_index.py``: image, annotation and
category indexes, ``get_ann_ids`` / ``load_anns`` lookups, and
``load_res`` for bbox results. Segmentation and keypoint results raise
``NotImplementedError``: the port has no RLE or OKS evaluation yet.
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional


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
        """A results index from bbox detection dicts ({image_id,
        category_id, bbox (xywh), score}), with area and ids assigned
        (pycocotools loadRes semantics for bbox results)."""
        res = COCOIndex()
        res.dataset["images"] = [copy.deepcopy(i) for i in self.dataset["images"]]
        res.dataset["categories"] = copy.deepcopy(self.dataset.get("categories", []))
        anns = copy.deepcopy(results)
        for idx, a in enumerate(anns):
            for kind in ("segmentation", "keypoints"):
                if kind in a:
                    raise NotImplementedError(
                        f"{kind} results: only bbox evaluation is ported")
            if "area" not in a:
                bb = a["bbox"]
                a["area"] = bb[2] * bb[3]
            a.setdefault("iscrowd", 0)
            a["id"] = idx + 1
        res.dataset["annotations"] = anns
        res._build()
        return res
