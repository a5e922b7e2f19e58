"""The train and eval steps: device blur, GT expansion, then loss,
backward and SGD, or predict.

Port of ``detectinblur_tpu/train/engine.py`` (``BlurBatch`` :27,
``images01`` :48, ``apply_blur_and_expand`` :63, ``make_train_step``
:126, ``prepare_eval_batch`` :205, ``make_eval_step`` :247). The JAX
steps are jitted programs; here they are eager torch, with RoIAlign's
forward and backward on the hand-written CUDA kernels. Both steps take
the loader's CPU batch and move it to the model's device first.

Not ported yet, and refused with ``NotImplementedError``: the Squint warp
(``use_warp``), the blur-conditional normalization (``use_custom_norm``),
the noise / block / JPEG corruptions, PSF dilation and deblur-first. The
port's model has no BatchNorm modes, so the steps have the JAX
signatures without ``bn_stats``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

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


def to_device(batch: BlurBatch, device) -> BlurBatch:
    """The batch on ``device``; ``hw`` stays on the host, where the
    preprocess and the model bucket read it."""
    return BlurBatch(*(t if name == "hw" else t.to(device)
                       for name, t in zip(BlurBatch._fields, batch)))


def _refuse(**options) -> None:
    asked = sorted(k for k, v in options.items() if v)
    if asked:
        raise NotImplementedError(f"not ported yet: {', '.join(asked)}")


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
    _refuse(use_warp=use_warp, use_custom_norm=use_custom_norm,
            add_noise=add_noise, add_block=add_block, add_jpeg=add_jpeg)

    def step(state: TrainState, batch: BlurBatch,
             generator: Optional[torch.Generator] = None, draws=None):
        if state.model is not model:
            raise ValueError("the state holds another model")
        batch = images01(to_device(batch, model.device))
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


def prepare_eval_batch(batch: BlurBatch, *, blur_eval: bool = False,
                       expand_target_boxes: bool = False,
                       precision: str = DEFAULT_PRECISION) -> BlurBatch:
    """The eval preamble: images to float 0..1, then with ``blur_eval``
    the device blur and, with ``expand_target_boxes``, the GT expansion.
    Nothing here is random: the JAX key feeds only the corruptions."""
    batch = images01(batch)
    if blur_eval:
        batch = apply_blur_and_expand(batch, expand_target_boxes,
                                      precision=precision)
    return batch


def make_eval_step(model, bucket: Tuple[int, int], blur_eval: bool = False,
                   expand_target_boxes: bool = False, use_warp: bool = False,
                   use_custom_norm: bool = False, deblur_first: bool = False,
                   add_noise: bool = False, add_block: bool = False,
                   add_jpeg: bool = False, dilate_psf: bool = False):
    """The eval step ``(model, batch, generator=None) -> (Detections,
    gt_boxes)`` for ``model`` at the model bucket ``bucket``: the batch
    moves to the model's device, goes through ``prepare_eval_batch`` and
    ``model.predict``; ``gt_boxes`` are the (expanded) GT boxes. The
    first two run in the profiler ranges ``eval.to_device`` and
    ``eval.blur_expand``. ``generator`` is the randomness of the
    eval-time corruptions, which are not ported: no option this step
    takes draws from it."""
    _refuse(use_warp=use_warp, use_custom_norm=use_custom_norm,
            deblur_first=deblur_first, add_noise=add_noise,
            add_block=add_block, add_jpeg=add_jpeg, dilate_psf=dilate_psf)

    @torch.no_grad()
    def step(model_, batch: BlurBatch,
             generator: Optional[torch.Generator] = None):
        if model_ is not model:
            raise ValueError("the step was made for another model")
        with record_function("eval.to_device"):
            batch = to_device(batch, model.device)
        with record_function("eval.blur_expand"):
            batch = prepare_eval_batch(
                batch, blur_eval=blur_eval,
                expand_target_boxes=expand_target_boxes,
                precision=model.cfg.precision)
        dets = model.predict(batch.images, batch.hw, bucket)
        return dets, batch.gt_boxes

    return step
