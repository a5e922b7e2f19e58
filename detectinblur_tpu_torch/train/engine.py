"""The training step: device blur, GT expansion, loss, backward, SGD.

Port of ``detectinblur_tpu/train/engine.py`` (``BlurBatch`` :27,
``images01`` :48, ``apply_blur_and_expand`` :63, ``make_train_step``
:126). The JAX step is one jitted program; here it is eager torch, with
RoIAlign's forward and backward on the hand-written CUDA kernels.

Not ported yet, and refused with ``NotImplementedError``: the Squint warp
(``use_warp``), the blur-conditional normalization (``use_custom_norm``),
the noise / block / JPEG corruptions and PSF dilation. The port's model
has no BatchNorm modes, so the step has the JAX signature without
``bn_stats``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from detectinblur_tpu_torch.ops.blur import batched_blur
from detectinblur_tpu_torch.ops.boxes import expand_boxes_by_psf
from detectinblur_tpu_torch.train.state import TrainState
from detectinblur_tpu_torch.utils.device import DEFAULT_PRECISION


class BlurBatch(NamedTuple):
    """Fixed-shape batch, the JAX ``BlurBatch`` as tensors, without the
    fields only the unported remedies read (warp angles, norm indices, the
    estimator label)."""

    images: torch.Tensor       # [B, Hb, Wb, 3] 0..1 float (or uint8), top-left
    hw: torch.Tensor           # [B, 2] valid sizes
    psfs: torch.Tensor         # [B, 128, 128]
    blurring: torch.Tensor     # [B] bool
    gt_boxes: torch.Tensor     # [B, G, 4] in image coordinates
    gt_labels: torch.Tensor    # [B, G]
    gt_valid: torch.Tensor     # [B, G] bool


def images01(batch: BlurBatch) -> BlurBatch:
    """uint8 images -> float32 0..1; float batches pass through."""
    if batch.images.dtype == torch.uint8:
        return batch._replace(images=batch.images.float() / 255.0)
    return batch


def apply_blur_and_expand(batch: BlurBatch, expand_target_boxes: bool,
                          precision: str = DEFAULT_PRECISION) -> BlurBatch:
    """Device-side blur of each image with its PSF (padding against its
    valid extent), then, with ``expand_target_boxes``, the PSF-driven GT
    expansion. The blur's FFT size follows ``precision``, as the JAX
    version's default: the exact padded size in ``highest``, the smooth
    size in ``default``."""
    blurred = batched_blur(batch.images.permute(0, 3, 1, 2), batch.psfs,
                           batch.blurring, exact=precision == "highest",
                           hw=batch.hw)
    gt_boxes = batch.gt_boxes
    if expand_target_boxes:
        hw = torch.as_tensor(batch.hw, device=gt_boxes.device)
        gt_boxes = expand_boxes_by_psf(gt_boxes, batch.psfs, batch.blurring,
                                       hw[:, 0], hw[:, 1])
    return batch._replace(images=blurred.permute(0, 2, 3, 1),
                          gt_boxes=gt_boxes)


def make_train_step(model, schedule: Callable[[int], float],
                    bucket: Tuple[int, int], blur_train: bool = True,
                    expand_target_boxes: bool = False, use_warp: bool = False,
                    use_custom_norm: bool = False, add_noise: bool = False,
                    add_block: bool = False, add_jpeg: bool = False):
    """The train step ``(state, batch, generator=None, draws=None) ->
    (state, metrics)`` for ``model`` (the one in ``state``), whose
    optimizer's learning rate follows ``schedule``. ``generator`` or
    ``draws`` (a ``faster_rcnn.LossDraws``) feed the loss's samplers.
    ``metrics`` holds the four losses and their sum ``loss``, detached."""
    unported = {"use_warp": use_warp, "use_custom_norm": use_custom_norm,
                "add_noise": add_noise, "add_block": add_block,
                "add_jpeg": add_jpeg}
    asked = sorted(k for k, v in unported.items() if v)
    if asked:
        raise NotImplementedError(f"not ported yet: {', '.join(asked)}")

    def step(state: TrainState, batch: BlurBatch,
             generator: Optional[torch.Generator] = None, draws=None):
        if state.model is not model:
            raise ValueError("the state holds another model")
        batch = images01(batch)
        if blur_train:
            batch = apply_blur_and_expand(batch, expand_target_boxes,
                                          precision=model.cfg.precision)
        losses = model.loss(batch.images, batch.hw, batch.gt_boxes,
                            batch.gt_labels, batch.gt_valid, bucket,
                            generator=generator, draws=draws)
        total = sum(losses.values())
        optimizer = state.optimizer
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        for group in optimizer.param_groups:
            group["lr"] = schedule(state.step)
        optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        return TrainState(state.step + 1, model, optimizer), metrics

    return step
