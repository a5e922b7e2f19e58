"""Natural-blur datasets (the reference's custom_datasets.py).

A copy of ``detectinblur_tpu/data/natural_datasets.py`` (numpy and PIL
only), kept here so that the port imports nothing of the JAX package.
Every class returns the loader's item dict (image [H, W, 3] uint8, boxes
xyxy, labels, area, iscrowd, image_id) with pseudo-ground-truth boxes read
from per-image ``*_DORS.npy`` dumps: arrays indexed by coco80 class, each
[N, 5] (x1, y1, x2, y2, confidence), thresholded at 0.4-0.6 and remapped
coco80 -> coco91 (custom_datasets.py:16-124 and utils.py:25-34).

Variants and their path wiring, as the reference's:
  * GOPRO       (:16-124): train/+test/ rglob *.png, blur/ vs sharp/;
                 annotations live next to the sharp frames.
  * VidBlur     (:126-229): rglob *.jpg, input/ vs GT/.
  * RealBlur    (:235-356): RealBlur_J_{train,test}_list.txt (gt path +
                 blur path per line), threshold 0.6.
  * REDS        (:360-487): blurry.txt / sharp.txt image lists.
  * GOPROSynth  (:783-899): blur made by averaging 2w+1 consecutive sharp
                 frames (truncated to uint8 after the clip), boxes
                 optionally expanded by walking their corners through
                 precomputed forward/backward optical flow (_flow.npy),
                 in float64.
  * GOPROSynthLoad: a rendered GOPROSynth set (``cli/dataset_tools.py``).
  * GOPROBlurEst: the blur estimator's split lists over such a set.

Items are marked ``pre_blurred``: the loader gives them no blur decision
(transforms.py:225-235).
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Sequence

import numpy as np
from PIL import Image


def with_suffix(path: str, suffix: str) -> str:
    """Swap a path's extension for ``suffix``. The datasets glob
    case-insensitively (*.[pP][nN][gG]), so a literal
    ``.replace(".png", ...)`` is a silent no-op on upper-case trees —
    splitext handles any casing."""
    return os.path.splitext(str(path))[0] + suffix


def coco80_to_coco91(idx80: int) -> int:
    """COCO paper class index -> annotation category id (utils.py:25-34)."""
    missing = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83}
    mapping = [i for i in range(1, 91) if i not in missing]
    return mapping[idx80]


def load_dors_targets(path: str, threshold: float):
    with open(path, "rb") as f:
        annotations = np.load(f, allow_pickle=True)
    boxes, labels = [], []
    for cls80, class_array in enumerate(annotations):
        arr = np.asarray(class_array).reshape(-1, 5)
        keep = arr[arr[:, 4] > threshold]
        for row in keep:
            boxes.append(row[:4])
            labels.append(coco80_to_coco91(cls80))
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    labels = np.asarray(labels, np.int32)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return boxes, labels, areas.astype(np.float32)


class _DORSDataset:
    """Base: image path list + parallel DORS annotation path list."""

    def __init__(self, image_paths: Sequence[str], ann_paths: Sequence[str],
                 threshold: float):
        self.image_paths = [str(p) for p in image_paths]
        self.ann_paths = [str(p) for p in ann_paths]
        self.threshold = threshold

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx: int):
        with Image.open(self.image_paths[idx]) as im:
            image = np.asarray(im.convert("RGB"))  # uint8 transport
        boxes, labels, areas = load_dors_targets(self.ann_paths[idx], self.threshold)
        return {
            "image": image,
            "image_id": idx,
            "boxes": boxes,
            "labels": labels,
            "area": areas,
            "iscrowd": np.zeros(len(labels), np.int32),
            "pre_blurred": True,
        }


class GOPRO(_DORSDataset):
    def __init__(self, root_dir: str, sharp_images=False, blurred_images=True,
                 threshold=0.4):
        paths = sorted(
            list(Path(os.path.join(root_dir, "train")).rglob("*.[pP][nN][gG]"))
            + list(Path(os.path.join(root_dir, "test")).rglob("*.[pP][nN][gG]"))
        )
        kind = "sharp/" if sharp_images else "blur/"
        paths = [p for p in paths if kind in str(p)]
        anns = [with_suffix(str(p).replace("blur", "sharp"), "_DORS.npy")
                for p in paths]
        super().__init__(paths, anns, threshold)


class VidBlur(_DORSDataset):
    def __init__(self, root_dir: str, sharp_images=False, blurred_images=True,
                 threshold=0.4):
        paths = sorted(Path(root_dir).rglob("*.[jJ][pP][gG]"))
        kind = "GT/" if sharp_images else "input/"
        paths = [p for p in paths if kind in str(p)]
        anns = [with_suffix(str(p).replace("input/", "GT/"), "_DORS.npy")
                for p in paths]
        super().__init__(paths, anns, threshold)


class RealBlur(_DORSDataset):
    def __init__(self, root_dir: str, sharp_images=False, blurred_images=True,
                 threshold=0.6):
        paths, anns = [], []
        for list_name in ("RealBlur_J_train_list.txt", "RealBlur_J_test_list.txt"):
            list_path = os.path.join(root_dir, list_name)
            if not os.path.exists(list_path):
                continue
            with open(list_path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) < 2:
                        continue
                    gt_rel, blur_rel = parts[0], parts[1]
                    img_rel = gt_rel if sharp_images else blur_rel
                    paths.append(os.path.join(root_dir, img_rel))
                    anns.append(os.path.join(
                        root_dir, with_suffix(gt_rel, "_DORS.npy")))
        super().__init__(paths, anns, threshold)


class REDS(_DORSDataset):
    def __init__(self, root_dir: str, sharp_images=False, blurred_images=True,
                 threshold=0.4):
        list_file = os.path.join(
            root_dir, "sharp.txt" if sharp_images else "blurry.txt")
        with open(list_file) as f:
            paths = [line.strip() for line in f if line.strip()]
        anns = [with_suffix(p.replace("blur", "sharp"), "_DORS.npy")
                for p in paths]
        super().__init__(paths, anns, threshold)


# ------------------------------------------------ GOPROSynth (frame-average)
def bilinear_flow_sample(flow: np.ndarray, x: float, y: float) -> np.ndarray:
    """Bilinear interpolation of a [H, W, 2] flow field
    (custom_datasets.py:585-621)."""
    h, w = flow.shape[:2]
    x = min(max(x, 0.0), w - 1.0)
    y = min(max(y, 0.0), h - 1.0)
    x0, y0 = int(x), int(y)
    x1, y1 = min(x0 + 1, w - 1), min(y0 + 1, h - 1)
    fx, fy = x - x0, y - y0
    return ((1 - fy) * ((1 - fx) * flow[y0, x0] + fx * flow[y0, x1])
            + fy * ((1 - fx) * flow[y1, x0] + fx * flow[y1, x1]))


def walk_through_flow(point, flows) -> np.ndarray:
    """Chain a point through consecutive flow fields
    (custom_datasets.py:701-735)."""
    p = np.asarray(point, np.float64).copy()
    for flow in flows:
        p = p + bilinear_flow_sample(flow, p[0], p[1])
    return p


def expand_boxes_with_flow(boxes: np.ndarray, fwd_flows, bwd_flows,
                           width: int, height: int) -> np.ndarray:
    """Expand boxes to cover their motion across the averaging window by
    walking all 4 corners through forward and backward flow chains and
    taking the min/max union (custom_datasets.py:636-699)."""
    out = boxes.copy()
    for i, (x1, y1, x2, y2) in enumerate(boxes):
        corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
        xs, ys = [x1, x2], [y1, y2]
        for chain in (fwd_flows, bwd_flows):
            for n in range(1, len(chain) + 1):
                for c in corners:
                    p = walk_through_flow(c, chain[:n])
                    xs.append(p[0])
                    ys.append(p[1])
        out[i] = [max(min(xs), 0), max(min(ys), 0),
                  min(max(xs), width - 1), min(max(ys), height - 1)]
    return out


class GOPROSynth:
    """Average 2w+1 consecutive sharp frames into a blurred frame
    (ImageInfo.blurImage, custom_datasets.py:737-763); targets from the
    center frame's DORS dump, optionally flow-expanded."""

    def __init__(self, root_dir: str, window: int = 5, threshold: float = 0.4,
                 expand_boxes: bool = False):
        self.window = window
        self.threshold = threshold
        self.expand_boxes = expand_boxes
        paths = sorted(
            list(Path(os.path.join(root_dir, "train")).rglob("*.[pP][nN][gG]"))
            + list(Path(os.path.join(root_dir, "test")).rglob("*.[pP][nN][gG]"))
        )
        paths = [p for p in paths if "sharp/" in str(p)]
        # Group by sequence directory; keep centers with a full window.
        by_seq = {}
        for p in paths:
            by_seq.setdefault(str(p.parent), []).append(str(p))
        self.centers = []
        for seq, frames in by_seq.items():
            frames.sort()
            for i in range(window, len(frames) - window):
                self.centers.append((frames, i))

    def __len__(self):
        return len(self.centers)

    def __getitem__(self, idx: int):
        frames, center = self.centers[idx]
        w = self.window
        acc = None
        for f in frames[center - w : center + w + 1]:
            with Image.open(f) as im:
                arr = np.asarray(im.convert("RGB"), np.float32)
            acc = arr if acc is None else acc + arr
        # Truncating cast after clip, matching the reference's return to
        # PIL (custom_datasets.py:753-757).
        image = np.clip(acc / (2 * w + 1), 0, 255).astype(np.uint8)

        ann = with_suffix(frames[center], "_DORS.npy")
        boxes, labels, areas = load_dors_targets(ann, self.threshold)
        if self.expand_boxes and len(boxes):
            fwd, bwd = [], []
            for k in range(center, center + w):
                fp = with_suffix(frames[k], "_flow.npy")
                if os.path.exists(fp):
                    fwd.append(np.load(fp))
            for k in range(center, center - w, -1):
                fp = with_suffix(frames[k], "_flow_bwd.npy")
                if os.path.exists(fp):
                    bwd.append(np.load(fp))
            boxes = expand_boxes_with_flow(
                boxes, fwd, bwd, image.shape[1], image.shape[0])
        return {
            "image": image,
            "image_id": idx,
            "boxes": boxes,
            "labels": labels,
            "area": areas,
            "iscrowd": np.zeros(len(labels), np.int32),
            "pre_blurred": True,
        }


class GOPROSynthLoad:
    """Pre-rendered GOPROSynth set: blur/NNNNN.png + pickled target .dat
    (custom_datasets.py:901-1063), as produced by
    cli/dataset_tools.py render-gopro-synth."""

    def __init__(self, root_dir: str, sharp_images=False, **_):
        sub = "sharp" if sharp_images else "blur"
        self.paths = sorted(Path(os.path.join(root_dir, sub)).glob("*.png"))

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int):
        p = self.paths[idx]
        with Image.open(p) as im:
            image = np.asarray(im.convert("RGB"))  # uint8 transport
        with open(with_suffix(p, ".dat"), "rb") as f:
            t = pickle.load(f)
        boxes = np.asarray(t["boxes"], np.float32).reshape(-1, 4)
        labels = np.asarray(t["labels"], np.int32)
        return {
            "image": image,
            "image_id": idx,
            "boxes": boxes,
            "labels": labels,
            "area": np.asarray(t.get("area",
                               (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])),
                               np.float32),
            "iscrowd": np.zeros(len(labels), np.int32),
            "pre_blurred": True,
        }


class GOPROBlurEst:
    """Blur-estimator classification split over rendered GOPRO images
    (custom_datasets.py:1074-1231). The split file
    (trainSplit.txt/valSplit.txt, written by segment_GOPRO.py:65-82) holds
    "imagePath,blurLabel" lines with the class label STORED per image
    (4 classes); the annotation path is the image path with .png -> .dat
    (a pickled target dict, :1115-1119). Train-split rebalancing drops
    label-0 lines w.p. 0.65 and label-1 lines w.p. 0.1 (:1121-1126).
    Items carry the stored label as ``blur_est_label`` and pass through the
    blur stage untouched (preBlurred, :1168-1178)."""

    def __init__(self, root_dir: str, split: str = "train", seed: int = 1337):
        self.train = "train" in split
        list_file = os.path.join(
            root_dir, "trainSplit.txt" if self.train else "valSplit.txt")
        with open(list_file) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        rng = np.random.default_rng(seed)
        items = []
        label_lists = {c: [] for c in range(4)}
        for ln in lines:
            img_path, label_s = ln.rsplit(",", 1)
            label = int(label_s)
            if self.train:
                if label == 0 and rng.random() < 0.65:
                    continue
                if label == 1 and rng.random() < 0.1:
                    continue
            items.append((img_path, with_suffix(img_path, ".dat"), label))
            label_lists[label].append(img_path)
        self.items = items
        self.class_counts = [len(label_lists[c]) for c in range(4)]
        total = max(sum(self.class_counts), 1)
        self.class_ratios = np.asarray(self.class_counts, np.float64) / total

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int):
        img_path, ann_path, label = self.items[idx]
        with Image.open(img_path) as im:
            image = np.asarray(im.convert("RGB"))  # uint8 transport
        with open(ann_path, "rb") as f:
            t = pickle.load(f)
        boxes = np.asarray(t["boxes"], np.float32).reshape(-1, 4)
        labels = np.asarray(t["labels"], np.int32)
        blurred_path = "blur" in img_path or "Blur" in img_path
        return {
            "image": image,
            "image_id": idx,
            "boxes": boxes,
            "labels": labels,
            "area": np.asarray(
                t.get("area", (boxes[:, 2] - boxes[:, 0])
                      * (boxes[:, 3] - boxes[:, 1])), np.float32),
            "iscrowd": np.zeros(len(labels), np.int32),
            "pre_blurred": True,
            "window_size": int(t.get("windowSize", 0)) if blurred_path else 0,
            "blur_est_label": label,
        }


def get_natural_dataset(name: str, root_dir: str, **kw):
    """evaluate.py --blurred_dataset dispatch."""
    # GOPROBlurEst is deliberately absent: it is a classification dataset
    # (estimator labels, no detection eval) consumed directly by
    # cli/train_blur_estimator.py with explicit train/val splits.
    table = {"GOPRO": GOPRO, "VidBlur": VidBlur, "RealBlur": RealBlur,
             "REDS": REDS, "GOPROSynth": GOPROSynth,
             "GOPROSynthLoad": GOPROSynthLoad}
    return table[name](root_dir, **kw)
