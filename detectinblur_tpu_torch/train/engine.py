"""The train and eval steps: device blur, corruptions, GT expansion, the
remedies' per-image inputs, then loss, backward and SGD, or predict.

Port of ``detectinblur_tpu/train/engine.py`` (``BlurBatch`` :27,
``images01`` :48, ``apply_blur_and_expand`` :63, ``derive_warp_params``
:111, ``make_train_step`` :126, ``_blur_norms`` :195,
``prepare_eval_batch`` :205, ``make_eval_step`` :247). The JAX steps are
jitted programs; here they are eager torch, with RoIAlign's forward and
backward on the hand-written CUDA kernels. Both steps take the loader's
CPU batch and move it to the model's device first.

The remedies, each a step option as in JAX: the Squint warp
(``use_warp``: warp parameters from each PSF's principal components), the
blur-conditional normalization (``use_custom_norm``), the noise, block and
JPEG corruptions after the blur, and in evaluation PSF dilation
(``dilate_psf``, sigma U(0, 3) per image, before the blur). The
BatchNorm modes are the model's (``FasterRCNNConfig.bn_mode``); their
running statistics are buffers that the train step's loss updates in
place, where JAX threads a ``bn_stats`` tree. Random draws come from the
step's ``generator`` unless the caller injects them. In evaluation,
deblur-first runs a ``models.deblur.MSResNet`` on every image after the
blur and the corruptions (``deblurrer``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from detectinblur_tpu_torch.models.deblur import MSResNet, deblur_image
from detectinblur_tpu_torch.ops.blur import batched_blur
from detectinblur_tpu_torch.ops.boxes import expand_boxes_by_psf
from detectinblur_tpu_torch.ops.normalization import get_norm_params
from detectinblur_tpu_torch.ops.psf import dilate_psf as dilate_psfs
from detectinblur_tpu_torch.ops.psf import psf_principal_components
from detectinblur_tpu_torch.parallel.dist import (
    data_parallel,
    process_count,
    sum_metrics,
)
from detectinblur_tpu_torch.train.estimator_engine import (
    CorruptionDraws,
    apply_corruptions,
)
from detectinblur_tpu_torch.train.state import TrainState
from detectinblur_tpu_torch.utils.device import (
    DEFAULT_PRECISION,
    to_device_async,
)
from detectinblur_tpu_torch.utils.profiling import span


class BlurBatch(NamedTuple):
    """Fixed-shape batch, the JAX ``BlurBatch`` as tensors. The remedies'
    and the estimator's fields come last and may be None in a batch made
    by hand (the loader fills them)."""

    images: torch.Tensor       # [B, Hb, Wb, 3] 0..1 float (or uint8), top-left
    hw: torch.Tensor           # [B, 2] valid sizes
    psfs: torch.Tensor         # [B, 128, 128]
    blurring: torch.Tensor     # [B] bool
    gt_boxes: torch.Tensor     # [B, G, 4] in image coordinates
    gt_labels: torch.Tensor    # [B, G]
    gt_valid: torch.Tensor     # [B, G] bool
    thetas: Optional[torch.Tensor] = None          # [B] warp angle
    lam1s: Optional[torch.Tensor] = None           # [B] warp scales
    lam2s: Optional[torch.Tensor] = None
    param_index: Optional[torch.Tensor] = None     # [B] int32, -1 when N/A
    fraction_index: Optional[torch.Tensor] = None  # [B] int32, -1 negligible
    # The estimator's stored class label (natural-blur estimator data);
    # -1 = derive it from the blur struct.
    est_label: Optional[torch.Tensor] = None       # [B] int32


def to_device(batch: BlurBatch, device) -> BlurBatch:
    """The batch on ``device``, each field in one copy that does not make
    the host wait (``to_device_async``: the loader pins the fields when
    the model is on a card); ``hw`` stays on the host, where the
    preprocess and the model bucket read it."""
    return BlurBatch(*(t if name == "hw" or t is None
                       else to_device_async(t, device)
                       for name, t in zip(BlurBatch._fields, batch)))


def images01(batch: BlurBatch) -> BlurBatch:
    """uint8 images -> float32 0..1; float batches pass through."""
    if batch.images.dtype == torch.uint8:
        return batch._replace(images=batch.images.float() / 255.0)
    return batch


def apply_blur_and_expand(batch: BlurBatch, expand_target_boxes: bool,
                          precision: str = DEFAULT_PRECISION,
                          add_noise: bool = False, noise_level: float = 0.001,
                          add_block: bool = False, add_jpeg: bool = False,
                          dilate_psf_sigma: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          corruption_draws: Optional[CorruptionDraws] = None
                          ) -> BlurBatch:
    """In the JAX order: with ``dilate_psf_sigma`` [B] the PSFs dilated;
    the device blur of each image with its PSF (padding against its valid
    extent); the corruptions asked for (draws from ``corruption_draws``,
    else ``generator``); then, with ``expand_target_boxes``, the
    PSF-driven GT expansion by the (dilated) PSFs. The blur's FFT size
    follows ``precision``, as the JAX version's default: the exact padded
    size in ``highest``, the smooth size in ``default``. The returned
    batch carries the dilated PSFs."""
    psfs = batch.psfs
    if dilate_psf_sigma is not None:
        psfs = dilate_psfs(psfs, dilate_psf_sigma.to(psfs.device))
    hw = to_device_async(batch.hw, batch.images.device)
    blurred = batched_blur(batch.images.permute(0, 3, 1, 2), psfs,
                           batch.blurring, exact=precision == "highest",
                           hw=hw).permute(0, 2, 3, 1)
    images = apply_corruptions(blurred, add_noise, noise_level, add_block,
                               add_jpeg, generator, corruption_draws)
    gt_boxes = batch.gt_boxes
    if expand_target_boxes:
        hw = hw.to(gt_boxes.device)
        gt_boxes = expand_boxes_by_psf(gt_boxes, psfs, batch.blurring,
                                       hw[:, 0], hw[:, 1])
    return batch._replace(images=images, gt_boxes=gt_boxes, psfs=psfs)


def derive_warp_params(batch: BlurBatch) -> BlurBatch:
    """The Squint warp parameters from the PSFs on the device; images that
    are not blurred get the identity (theta 0, lambda 1)."""
    comps = psf_principal_components(batch.psfs)
    on = batch.blurring.bool()
    return batch._replace(
        thetas=torch.where(on, comps.theta_rad, 0.0),
        lam1s=torch.where(on, comps.scale_factor_lambda1, 1.0),
        lam2s=torch.where(on, comps.scale_factor_lambda2, 1.0))


def _blur_norms(batch: BlurBatch, use_custom_norm: bool):
    """(means, stds) [B, 3] of the blur-conditional normalization, or
    (None, None) for the ImageNet statistics."""
    if not use_custom_norm:
        return None, None
    return get_norm_params(batch.blurring, batch.param_index,
                           batch.fraction_index)


def remedy_kwargs(batch: BlurBatch, use_warp: bool, use_custom_norm: bool):
    """The keyword arguments of ``predict`` / ``loss`` for the remedies."""
    means, stds = _blur_norms(batch, use_custom_norm)
    kw = dict(means=means, stds=stds)
    if use_warp:
        kw.update(thetas=batch.thetas, lam1s=batch.lam1s, lam2s=batch.lam2s)
    return kw


def make_train_step(model, schedule: Callable[[int], float],
                    bucket: Tuple[int, int], blur_train: bool = True,
                    expand_target_boxes: bool = False, use_warp: bool = False,
                    use_custom_norm: bool = False, add_noise: bool = False,
                    noise_level: float = 0.001, add_block: bool = False,
                    add_jpeg: bool = False):
    """The train step ``(state, batch, generator=None, draws=None,
    corruption_draws=None) -> (state, metrics)`` for ``model`` (the one
    in ``state``), whose optimizer's learning rate follows ``schedule``.
    ``generator`` feeds the corruptions and the loss's samplers;
    ``draws`` (a ``faster_rcnn.LossDraws``) and ``corruption_draws``
    replace their draws. ``metrics`` holds the four losses and their sum
    ``loss``, detached. A ``bn_mode`` model's running statistics move in
    place.

    Made under a process group, the step runs ``model.loss`` in the
    model's ``DistributedDataParallel`` (``parallel/dist.py``) on this
    process's part of the global batch, and ``metrics`` are the global
    batch's losses; the update equals one process's step on the whole
    global batch."""
    ddp = data_parallel(model)

    def step(state: TrainState, batch: BlurBatch,
             generator: Optional[torch.Generator] = None, draws=None,
             corruption_draws: Optional[CorruptionDraws] = None):
        if state.model is not model:
            raise ValueError("the state holds another model")
        batch = images01(to_device(batch, model.device))
        if blur_train:
            batch = apply_blur_and_expand(
                batch, expand_target_boxes, precision=model.cfg.precision,
                add_noise=add_noise, noise_level=noise_level,
                add_block=add_block, add_jpeg=add_jpeg, generator=generator,
                corruption_draws=corruption_draws)
        if use_warp:
            batch = derive_warp_params(batch)

        def loss(m):
            return m.loss(batch.images, batch.hw, batch.gt_boxes,
                          batch.gt_labels, batch.gt_valid, bucket,
                          generator=generator, draws=draws,
                          **remedy_kwargs(batch, use_warp, use_custom_norm))

        with span("train.forward"):
            losses = loss(model) if ddp is None else ddp(loss)
            total = sum(losses.values())
        optimizer = state.optimizer
        optimizer.zero_grad(set_to_none=True)
        # DDP averages the gradients over the W processes; each process's
        # losses are its share of the global batch's sums, so W times them
        # gives the global losses' gradient. On a card the autograd engine
        # launches the backward's kernels from its own thread, outside
        # this span.
        with span("train.backward"):
            (total if ddp is None else total * process_count()).backward()
        with span("train.optimizer"):
            for group in optimizer.param_groups:
                group["lr"] = schedule(state.step)
            optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        if ddp is not None:
            metrics = sum_metrics(metrics)
        return TrainState(state.step + 1, model, optimizer), metrics

    return step


def prepare_eval_batch(batch: BlurBatch,
                       generator: Optional[torch.Generator] = None, *,
                       blur_eval: bool = False,
                       expand_target_boxes: bool = False,
                       precision: str = DEFAULT_PRECISION,
                       add_noise: bool = False, noise_level: float = 0.001,
                       add_block: bool = False, add_jpeg: bool = False,
                       dilate_psf: bool = False, use_warp: bool = False,
                       dilate_psf_sigma: Optional[torch.Tensor] = None,
                       corruption_draws: Optional[CorruptionDraws] = None,
                       deblurrer: Optional[MSResNet] = None) -> BlurBatch:
    """The eval preamble in the JAX order: images to float 0..1; with
    ``blur_eval`` the PSF dilation (sigma U(0, 3) per image, or
    ``dilate_psf_sigma``), the device blur, the corruptions and the GT
    expansion; with a ``deblurrer``, deblur-first on every image of the
    batch (its whole canvas, as JAX vmaps it); then, with ``use_warp``,
    the warp parameters. Draws come from ``generator`` unless injected.
    The single-model and the ensemble eval both run through here."""
    batch = images01(batch)
    if blur_eval:
        sigma = dilate_psf_sigma
        if dilate_psf and sigma is None:
            sigma = 3.0 * torch.rand(batch.images.shape[0],
                                     generator=generator,
                                     device=batch.images.device)
        batch = apply_blur_and_expand(
            batch, expand_target_boxes, precision=precision,
            add_noise=add_noise, noise_level=noise_level, add_block=add_block,
            add_jpeg=add_jpeg, dilate_psf_sigma=sigma if dilate_psf else None,
            generator=generator, corruption_draws=corruption_draws)
    if deblurrer is not None:
        batch = batch._replace(images=deblur_image(deblurrer, batch.images))
    if use_warp:
        batch = derive_warp_params(batch)
    return batch


def make_eval_step(model, bucket: Tuple[int, int], blur_eval: bool = False,
                   expand_target_boxes: bool = False, use_warp: bool = False,
                   use_custom_norm: bool = False,
                   deblurrer: Optional[MSResNet] = None,
                   add_noise: bool = False, noise_level: float = 0.001,
                   add_block: bool = False, add_jpeg: bool = False,
                   dilate_psf: bool = False):
    """The eval step ``(model, batch, generator=None, dilate_psf_sigma=None,
    corruption_draws=None) -> (Detections, gt_boxes)`` for ``model`` at
    the model bucket ``bucket``: the batch moves to the model's device,
    goes through ``prepare_eval_batch`` and ``model.predict`` with the
    remedies asked for; ``gt_boxes`` are the (expanded) GT boxes. The
    first two run in the spans (``utils.profiling.span``)
    ``eval.to_device`` and ``eval.blur_expand`` (deblur-first included).
    ``generator`` (on the model's device) is the randomness of the PSF
    dilation and the corruptions."""

    @torch.no_grad()
    def step(model_, batch: BlurBatch,
             generator: Optional[torch.Generator] = None,
             dilate_psf_sigma: Optional[torch.Tensor] = None,
             corruption_draws: Optional[CorruptionDraws] = None):
        if model_ is not model:
            raise ValueError("the step was made for another model")
        with span("eval.to_device"):
            batch = to_device(batch, model.device)
        with span("eval.blur_expand"):
            batch = prepare_eval_batch(
                batch, generator, blur_eval=blur_eval,
                expand_target_boxes=expand_target_boxes,
                precision=model.cfg.precision, add_noise=add_noise,
                noise_level=noise_level, add_block=add_block,
                add_jpeg=add_jpeg, dilate_psf=dilate_psf, use_warp=use_warp,
                dilate_psf_sigma=dilate_psf_sigma,
                corruption_draws=corruption_draws, deblurrer=deblurrer)
        dets = model.predict(batch.images, batch.hw, bucket,
                             **remedy_kwargs(batch, use_warp,
                                              use_custom_norm))
        return dets, batch.gt_boxes

    return step
