"""Batched normalize + resize into a static model bucket.

Port of ``detectinblur_tpu/models/detection_transform.py``: every image is
normalized, resized so its min side reaches ``min_size`` (max side at most
``max_size``) with torch bilinear (``align_corners=False``), and placed at
the top-left of a zero [Ho, Wo] bucket; its new valid size travels beside
it.

The sizes are computed on the host in float32, with the same arithmetic as
the JAX version, from ``hw`` (a host array), so no device sync is needed to
size the ``F.interpolate`` calls; ``resize_batch`` takes them computed
(``predict`` holds them, and their device copies, a key at a time). The JAX version replicates the last valid
row and column one pixel outward (``resize_valid`` :57-60) because its
bucket holds zeros there; interpolating only the valid crop clamps at its
edge, which is the same thing.

Per-image means and stds [B, 3] (the blur-conditional normalization of
``ops/normalization.py``) replace the ImageNet constants when given.
``crop_images=True`` batches by cropping every image to the smallest
resized extent floored to /32 (the blur estimator's input). The blur
estimator's own resize round trip uses ``resize_into_bucket`` and
``resize_valid`` one image at a time. ``normalize=False`` is not ported
yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from detectinblur_tpu_torch.utils.device import (
    device_constant,
    to_device_async,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def host_hw(hw) -> np.ndarray:
    """``hw`` (a host array, or a tensor, copied back) as int64 [B, 2]."""
    if isinstance(hw, torch.Tensor):
        hw = hw.cpu().numpy()
    return np.asarray(hw).astype(np.int64).reshape(-1, 2)


def resize_scale(h, w, min_size: int, max_size: int) -> np.ndarray:
    """torchvision _resize_image_and_masks scale (float32): min_size/min
    clamped so the max side stays <= max_size."""
    h = np.float32(h)
    w = np.float32(w)
    return np.minimum(np.float32(min_size) / np.minimum(h, w),
                      np.float32(max_size) / np.maximum(h, w))


def resized_valid_hw(hw, out_shape: Tuple[int, int], min_size: int = 800,
                     max_size: int = 1333) -> np.ndarray:
    """New valid sizes [B, 2] inside the ``out_shape`` bucket after the
    min/max-side resize (``bucket_hw``)."""
    return np.asarray([bucket_hw((h, w), resize_scale(h, w, min_size,
                                                      max_size), out_shape)
                       for h, w in host_hw(hw)], np.int64).reshape(-1, 2)


def bucket_hw(hw, scale, out_shape: Tuple[int, int]) -> Tuple[int, int]:
    """The valid size (``resize_into_bucket`` :83) of an image of size
    ``hw`` resized by ``scale`` into the ``out_shape`` bucket, in float32:
    floor(size * scale), the scale first shrunk (aspect kept) so the image
    fits the bucket."""
    Ho, Wo = out_shape
    hf, wf = np.float32(hw[0]), np.float32(hw[1])
    scale = np.minimum(np.float32(scale),
                       np.minimum(np.float32(Ho) / hf, np.float32(Wo) / wf))
    return (min(int(np.floor(hf * scale)), Ho),
            min(int(np.floor(wf * scale)), Wo))


def resize_valid(image: torch.Tensor, hw, new_hw,
                 out_shape: Tuple[int, int]) -> torch.Tensor:
    """Resize the valid [h, w] region of ``image`` [Hb0, Wb0, C] (at its
    top-left) to exactly ``new_hw`` inside a zero [Ho, Wo, C] bucket, torch
    bilinear with ``align_corners=False`` (``resize_valid`` :43); sizes
    are host integers."""
    (h, w), (nh, nw) = (int(v) for v in hw), (int(v) for v in new_hw)
    out = image.new_zeros(*out_shape, image.shape[-1], dtype=torch.float32)
    out[:nh, :nw] = _resize(image[:h, :w].float(), nh, nw)
    return out


def _resize(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """[h, w, C] -> [nh, nw, C], torch bilinear, ``align_corners=False``."""
    return F.interpolate(img.permute(2, 0, 1)[None], size=(nh, nw),
                         mode="bilinear", align_corners=False)[0].permute(1, 2, 0)


def resize_into_bucket(image: torch.Tensor, hw, scale,
                       out_shape: Tuple[int, int]):
    """Resize the valid region by ``scale`` into a zero bucket
    (``resize_into_bucket`` :83) -> (image [Ho, Wo, C], new (h, w))."""
    new_hw = bucket_hw(hw, scale, out_shape)
    return resize_valid(image, hw, new_hw, out_shape), new_hw


def _stat(values, default, device) -> torch.Tensor:
    if values is None:
        return device_constant(default, device, torch.float32)
    return torch.as_tensor(values, dtype=torch.float32, device=device)


def normalize_image(image: torch.Tensor, mean=None, std=None) -> torch.Tensor:
    """(image - mean) / std over the trailing channel axis, ImageNet's
    statistics (one cached copy per device) unless ``mean`` and ``std``
    [3] are given."""
    return ((image - _stat(mean, IMAGENET_MEAN, image.device))
            / _stat(std, IMAGENET_STD, image.device))


def resize_boxes(boxes: torch.Tensor, orig_hw: torch.Tensor,
                 new_hw: torch.Tensor) -> torch.Tensor:
    """torchvision resize_boxes with independent x/y ratios; ``orig_hw``
    and ``new_hw`` [..., 2] broadcast against ``boxes[..., 0, :]``."""
    orig_hw = orig_hw.float()
    ry = new_hw[..., 0:1].float() / orig_hw[..., 0:1]
    rx = new_hw[..., 1:2].float() / orig_hw[..., 1:2]
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1 * rx, y1 * ry, x2 * rx, y2 * ry], dim=-1)


def resize_batch(images: torch.Tensor, hw: np.ndarray, new_hw: np.ndarray,
                 out_shape: Tuple[int, int],
                 means: Optional[torch.Tensor] = None,
                 stds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The valid [h, w] region of each image of ``images`` [B, Hb0, Wb0, 3]
    (raw 0..1, at the top-left) normalized, with its row of ``means`` and
    ``stds`` when given, and resized to exactly its ``new_hw`` inside a
    zero [B, Ho, Wo, 3] float32 bucket. ``hw`` and ``new_hw`` are host
    int64 [B, 2] arrays (``host_hw``, ``resized_valid_hw``)."""
    Ho, Wo = out_shape
    out = images.new_zeros(images.shape[0], Ho, Wo, images.shape[-1],
                           dtype=torch.float32)
    for b in range(images.shape[0]):
        h, w = (int(v) for v in hw[b])
        nh, nw = (int(v) for v in new_hw[b])
        img = normalize_image(images[b, :h, :w].float(),
                              None if means is None else means[b],
                              None if stds is None else stds[b])
        out[b, :nh, :nw] = _resize(img, nh, nw)
    return out


def preprocess_batch(
    images: torch.Tensor,   # [B, Hb0, Wb0, 3] raw 0..1, valid at top-left
    hw,                     # [B, 2] valid sizes, host array or tensor
    out_shape: Tuple[int, int],
    min_size: int = 800,
    max_size: int = 1333,
    means: Optional[torch.Tensor] = None,   # [B, 3] per-image overrides
    stds: Optional[torch.Tensor] = None,
    crop_images: bool = False,
):
    """Batched normalize + resize into the model bucket, each image
    normalized with its row of ``means`` and ``stds`` when given. With
    ``crop_images`` everything beyond the smallest resized extent, floored
    to /32, is zeroed and every image reports that size (JAX :167-174).

    Returns (batched [B, Ho, Wo, 3] float32, new_hw [B, 2] int64 on the
    images' device, copied there without a host sync).
    """
    B = images.shape[0]
    hw_np = host_hw(hw)
    new_hw = resized_valid_hw(hw_np, out_shape, min_size, max_size)
    out = resize_batch(images, hw_np, new_hw, out_shape, means, stds)
    if crop_images:
        mh, mw = (int(v) // 32 * 32 for v in new_hw.min(axis=0))
        out[:, mh:] = 0.0
        out[:, :, mw:] = 0.0
        new_hw = np.tile(np.asarray([[mh, mw]], np.int64), (B, 1))
    return out, to_device_async(new_hw, images.device)
