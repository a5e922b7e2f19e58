"""Fixed-shape batch assembly (host side).

Port of ``detectinblur_tpu/data/batching.py``: images are grouped by
orientation into a few source buckets, padded top-left with zeros and
emitted as a ``BlurBatch`` of CPU tensors (uint8 images; the step moves
the batch to the model's device and rescales there), with each blurred
image's (blur type, exposure) indices for the blur-conditional norms. Each batch also gets
its model bucket (``model_bucket_for_batch``, the torch-exact resized
extent rounded up to 64) and a GT-slot count from ``GT_BUCKETS``.
Horizontal flipping happens here, before box padding.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from detectinblur_tpu_torch.data.blur_sampling import BlurDecision
from detectinblur_tpu_torch.train.engine import BlurBatch

# (h, w) source buckets; images are assigned by orientation and size. The
# loader reads this at run time, so tests can patch it.
DEFAULT_SOURCE_BUCKETS = ((512, 672), (672, 512), (672, 672))

GT_BUCKETS = (8, 16, 32, 64, 100)


def pick_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]):
    """Smallest bucket that fits (h, w); falls back to the largest."""
    candidates = [b for b in buckets if b[0] >= h and b[1] >= w]
    if not candidates:
        return max(buckets, key=lambda b: b[0] * b[1])
    return min(candidates, key=lambda b: b[0] * b[1])


def model_bucket_for(source_bucket: Tuple[int, int], min_size=800, max_size=1333,
                     divisor=32) -> Tuple[int, int]:
    """Model bucket big enough for any image at the source bucket's aspect
    ratio after the min/max-side resize."""
    h, w = source_bucket
    scale = min(min_size / min(h, w), max_size / max(h, w))
    Ho = int(np.ceil(h * scale / divisor) * divisor)
    Wo = int(np.ceil(w * scale / divisor) * divisor)
    return Ho, Wo


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


def hflip_item(item: Dict) -> Dict:
    img = item["image"][:, ::-1]
    w = item["image"].shape[1]
    boxes = item["boxes"].copy()
    boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return dict(item, image=img, boxes=boxes)


def gt_bucket_for_batch(counts, max_gt: int = 100) -> int:
    """GT-slot count for a batch: the smallest ``GT_BUCKETS`` entry that
    holds the batch's largest annotation count, capped at ``max_gt``."""
    need = min(max(counts, default=1), max_gt)
    for b in GT_BUCKETS:
        if need <= b:
            return min(b, max_gt)
    return max_gt


def build_blur_batch(
    items: List[Dict],
    decisions: List[BlurDecision],
    psf_bank: Optional[np.ndarray],     # [P, F, N, 128, 128] or None
    source_bucket: Tuple[int, int],
    max_gt: int = 100,
    bucket_gt: bool = True,
) -> BlurBatch:
    """A ``BlurBatch`` of CPU tensors for a list of same-bucket items.

    With ``bucket_gt`` the GT slots are the batch's GT bucket
    (``gt_bucket_for_batch``), else ``max_gt``: processes that must feed
    one shape per step pass ``bucket_gt=False``. Labels are int64, the
    dtype the loss indexes with (the JAX package ships int32)."""
    B = len(items)
    Hb, Wb = source_bucket
    if bucket_gt:
        max_gt = gt_bucket_for_batch([len(it["boxes"]) for it in items],
                                     max_gt)
    images = np.zeros((B, Hb, Wb, 3), np.uint8)
    hw = np.zeros((B, 2), np.int32)
    psfs = np.zeros((B, 128, 128), np.float32)
    blurring = np.zeros(B, bool)
    param_index = np.full(B, -1, np.int32)
    fraction_index = np.full(B, -1, np.int32)
    est_label = np.full(B, -1, np.int32)
    gt_boxes = np.zeros((B, max_gt, 4), np.float32)
    gt_labels = np.zeros((B, max_gt), np.int64)
    gt_valid = np.zeros((B, max_gt), bool)

    for i, (item, dec) in enumerate(zip(items, decisions)):
        img = item["image"]
        h, w = img.shape[:2]
        if h > Hb or w > Wb:
            raise ValueError(f"image {(h, w)} exceeds bucket {source_bucket}")
        if img.dtype == np.uint8:
            images[i, :h, :w] = img
        else:
            images[i, :h, :w] = np.rint(
                np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
        hw[i] = (h, w)
        n = min(len(item["boxes"]), max_gt)
        gt_boxes[i, :n] = item["boxes"][:n]
        gt_labels[i, :n] = item["labels"][:n]
        gt_valid[i, :n] = True
        est_label[i] = item.get("blur_est_label", -1)
        if dec.blurring and dec.fraction_index >= 0 and psf_bank is not None:
            blurring[i] = True
            param_index[i] = dec.param_index
            fraction_index[i] = dec.fraction_index
            psfs[i] = psf_bank[dec.param_index, dec.fraction_index,
                               dec.psf_index % psf_bank.shape[2]]

    # The warp parameters are the identity until the step derives them
    # from the (blurred) PSFs.
    return BlurBatch(*(torch.from_numpy(a) for a in (
        images, hw, psfs, blurring, gt_boxes, gt_labels, gt_valid,
        np.zeros(B, np.float32), np.ones(B, np.float32),
        np.ones(B, np.float32), param_index, fraction_index, est_label)))
