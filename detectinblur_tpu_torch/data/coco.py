"""COCO detection dataset (host side).

Port of ``CocoDetection``, ``get_coco`` and ``get_coco_kp``
(``detectinblur_tpu/data/coco.py:22,110,124``): xywh -> xyxy boxes
clamped to the image, crowd annotations dropped, degenerate boxes
dropped, and empty images filtered out of the train split. Items are the
same numpy dicts: image [H, W, 3] uint8, boxes [N, 4] float32 xyxy,
labels [N] int32, image_id, area, iscrowd; with ``with_masks`` also
masks [N, H, W] uint8 (from polygons or RLE), with ``with_keypoints``
keypoints [N, K, 3] float32 (x, y, visibility), padded to the largest K
of the image.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
from PIL import Image

from detectinblur_tpu_torch.eval import rle as rle_mod
from detectinblur_tpu_torch.eval.coco_index import COCOIndex


class CocoDetection:
    def __init__(
        self,
        img_dir: str,
        ann_file: str | dict,
        train_filter: bool = False,
        with_masks: bool = False,
        with_keypoints: bool = False,
    ):
        self.img_dir = img_dir
        self.index = COCOIndex(ann_file)
        self.with_masks = with_masks
        self.with_keypoints = with_keypoints
        self.ids = self.index.get_img_ids()
        if train_filter:
            self.ids = [i for i in self.ids if self._has_valid_anns(i)]

    def _anns(self, img_id) -> List[dict]:
        return [a for a in self.index.img_to_anns[img_id] if a.get("iscrowd", 0) == 0]

    def _has_valid_anns(self, img_id) -> bool:
        """Non-empty, with a box wider and taller than one pixel."""
        return any(a["bbox"][2] > 1 and a["bbox"][3] > 1
                   for a in self._anns(img_id))

    def __len__(self):
        return len(self.ids)

    def load_image(self, img_id) -> np.ndarray:
        info = self.index.imgs[img_id]
        path = os.path.join(self.img_dir, info["file_name"])
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    def __getitem__(self, i: int) -> Dict:
        img_id = self.ids[i]
        return self.make_target(img_id, self.load_image(img_id))

    def make_target(self, img_id, img: np.ndarray) -> Dict:
        h, w = img.shape[:2]
        anns = self._anns(img_id)
        boxes = np.array([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
        boxes[:, 2:] += boxes[:, :2]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
        anns = [a for a, k in zip(anns, keep) if k]
        out = {
            "image": img,
            "image_id": img_id,
            "boxes": boxes[keep],
            "labels": np.array([a["category_id"] for a in anns], np.int32),
            "area": np.array([a["area"] for a in anns], np.float32),
            "iscrowd": np.zeros(len(anns), np.int32),
        }
        if self.with_masks:
            out["masks"] = np.stack(
                [rle_mod.masks_from_segmentation(a["segmentation"], h, w)
                 for a in anns]) if anns else np.zeros((0, h, w), np.uint8)
        if self.with_keypoints:
            kps = [np.asarray(a.get("keypoints", []), np.float32).reshape(-1, 3)
                   for a in anns]
            K = max((k.shape[0] for k in kps), default=0)
            kps = [np.pad(k, ((0, K - k.shape[0]), (0, 0))) for k in kps]
            out["keypoints"] = (np.stack(kps) if anns and K else
                                np.zeros((len(anns), K, 3), np.float32))
        return out


def get_coco(root: str, image_set: str = "train") -> CocoDetection:
    """``{root}/{train,val}2017`` images with
    ``{root}/annotations/instances_{train,val}2017.json``; the train split
    drops images without a usable box."""
    paths = {
        "train": ("train2017", "annotations/instances_train2017.json"),
        "val": ("val2017", "annotations/instances_val2017.json"),
    }
    img_folder, ann_file = paths[image_set]
    return CocoDetection(
        os.path.join(root, img_folder),
        os.path.join(root, ann_file),
        train_filter=(image_set == "train"),
    )


def get_coco_kp(root: str, image_set: str = "train") -> CocoDetection:
    """``get_coco`` on the person-keypoint annotations
    (``annotations/person_keypoints_{train,val}2017.json``), items with
    their keypoints."""
    paths = {
        "train": ("train2017", "annotations/person_keypoints_train2017.json"),
        "val": ("val2017", "annotations/person_keypoints_val2017.json"),
    }
    img_folder, ann_file = paths[image_set]
    return CocoDetection(
        os.path.join(root, img_folder),
        os.path.join(root, ann_file),
        train_filter=(image_set == "train"),
        with_keypoints=True,
    )
