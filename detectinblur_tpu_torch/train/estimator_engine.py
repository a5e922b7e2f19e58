"""The blur estimator's train and eval steps, and the image corruptions
of the blur pipeline.

Port of ``detectinblur_tpu/train/estimator_engine.py``.
``apply_corruptions`` (:34-74) is the corruption chain the reference's
manual_blur runs on each blurred image (blur_functions.py:72-88): noise,
block, JPEG and, for the estimator, quantization to 8 bits. Every draw is
per image: the noise variance U(1e-8, noise_level) and the noise; the
block decision (U > 0.5) and scale U(0.6, 1); the JPEG decision
(U > 0.35) and quality U(20, 90). The draws come from a
``torch.Generator``, or from a ``CorruptionDraws`` given by the caller
(the tests feed the values JAX draws from its keys).

The estimator's steps (:90-213): the device blur of the batch, with
``resize_images`` at the estimator's own min-side-800 scale
(``blur_batch_images``), the corruptions, the normalize + resize into the
model bucket (``crop_images`` crops the batch to its smallest extent),
the class labels from the blur struct, then cross-entropy with optional
label smoothing and SGD with weight decay (train), or eval-mode
BatchNorm with top-1 and top-2 (eval).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from detectinblur_tpu_torch.models.batchnorm import bn_mode, training_mode
from detectinblur_tpu_torch.models.classifier import (
    estimator_label,
    estimator_label_lehe,
)
from detectinblur_tpu_torch.models.detection_transform import (
    preprocess_batch,
    resize_into_bucket,
    resize_valid,
)
from detectinblur_tpu_torch.ops.blur import batched_blur
from detectinblur_tpu_torch.ops.jpeg import jpeg_compress_decompress
from detectinblur_tpu_torch.parallel.dist import (
    data_parallel,
    process_count,
    sum_metrics,
)


class CorruptionDraws(NamedTuple):
    """One row per image; the fields of a corruption that is off are not
    read and may be None."""
    noise_var: Optional[torch.Tensor] = None   # [B], U(1e-8, noise_level)
    noise: Optional[torch.Tensor] = None       # [B, H, W, 3], N(0, 1)
    block_u: Optional[torch.Tensor] = None     # [B], U(0, 1): block if > 0.5
    block_scale: Optional[torch.Tensor] = None  # [B], U(0.6, 1)
    jpeg_u: Optional[torch.Tensor] = None      # [B], U(0, 1): JPEG if > 0.35
    jpeg_quality: Optional[torch.Tensor] = None  # [B], U(20, 90)


def draw_corruptions(images: torch.Tensor, add_noise: bool,
                     noise_level: float, add_block: bool, add_jpeg: bool,
                     generator: Optional[torch.Generator] = None
                     ) -> CorruptionDraws:
    """The draws of the corruptions that are on, from ``generator`` (on
    the images' device)."""
    B = images.shape[0]
    dev = images.device

    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(B, generator=generator, device=dev)

    d = {}
    if add_noise:
        d["noise_var"] = u(1e-8, noise_level)
        d["noise"] = torch.randn(images.shape, generator=generator,
                                 device=dev)
    if add_block:
        d["block_u"], d["block_scale"] = u(), u(0.6, 1.0)
    if add_jpeg:
        d["jpeg_u"], d["jpeg_quality"] = u(), u(20.0, 90.0)
    return CorruptionDraws(**d)


def apply_corruptions(images: torch.Tensor, add_noise: bool = False,
                      noise_level: float = 0.001, add_block: bool = False,
                      add_jpeg: bool = False,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[CorruptionDraws] = None,
                      quantize: bool = False) -> torch.Tensor:
    """images [B, H, W, 3] float 0..1 (H and W multiples of 16 for JPEG)
    -> the corrupted images: noise, then block, then JPEG, then the
    quantization to 8 bits (round half to even), each as asked. Draws
    come from ``draws`` or, when that is None, from ``generator``."""
    if not (add_noise or add_block or add_jpeg or quantize):
        return images
    if draws is None:
        draws = draw_corruptions(images, add_noise, noise_level, add_block,
                                 add_jpeg, generator)
    dev = images.device
    B, H, W, _ = images.shape
    img = images
    if add_noise:
        std = torch.sqrt(draws.noise_var.to(dev))[:, None, None, None]
        img = (img + draws.noise.to(dev) * std).clamp(0.0, 1.0)
    if add_block:
        # Nearest down- and up-sampling by the scale, as an index gather:
        # floor(i / s) * s in float32, truncated to an index.
        s = draws.block_scale.to(dev, torch.float32)[:, None]

        def index(n):
            i = torch.arange(n, dtype=torch.float32, device=dev)[None]
            return (torch.floor(i / s) * s).clamp(0, n - 1).long()

        b = torch.arange(B, device=dev)[:, None, None]
        blocked = img[b, index(H)[:, :, None], index(W)[:, None, :]]
        img = torch.where((draws.block_u.to(dev) > 0.5)[:, None, None, None],
                          blocked, img)
    if add_jpeg:
        compressed = jpeg_compress_decompress(img, draws.jpeg_quality.to(dev))
        img = torch.where((draws.jpeg_u.to(dev) > 0.35)[:, None, None, None],
                          compressed, img)
    if quantize:
        img = torch.round(img * 255.0) / 255.0
    return img


def estimator_resize_canvas(Hb: int, Wb: int, aspect_cap: float = 2.0
                            ) -> Tuple[int, int]:
    """The square canvas (:77) that holds the min-side-800 resize of any
    image of the (Hb, Wb) bucket up to the aspect ratio ``aspect_cap``."""
    side = -(-int(round(800 * aspect_cap)) // 32) * 32
    bucket_fit = -(-int(round(800 * max(Hb, Wb) / min(Hb, Wb))) // 32) * 32
    side = max(side, bucket_fit)
    return side, side


def blur_batch_images(batch, resize_images: bool = False) -> torch.Tensor:
    """The device blur of ``batch`` (images float 0..1 on the device, ``hw``
    on the host) -> [B, Hb, Wb, 3]. With ``resize_images`` each blurred
    image is resized so its short side is 800 (inside the
    ``estimator_resize_canvas``), blurred there and resized back to its
    own size, the estimator's manual_blur (:90); images that are not
    blurred stay as they are."""
    chw = lambda x: x.permute(0, 3, 1, 2)
    hwc = lambda x: x.permute(0, 2, 3, 1)
    if not resize_images:
        return hwc(batched_blur(chw(batch.images), batch.psfs,
                                batch.blurring, hw=batch.hw))
    Hb, Wb = batch.images.shape[1:3]
    RH, RW = estimator_resize_canvas(Hb, Wb)
    hw = np.asarray(batch.hw).reshape(-1, 2)
    big, big_hw = [], []
    for img, (h, w) in zip(batch.images, hw):
        h, w = np.float32(h), np.float32(w)
        scale = np.minimum(np.float32(800.0) / np.minimum(h, w),
                           np.minimum(np.float32(RH) / h, np.float32(RW) / w))
        b, bhw = resize_into_bucket(img, (h, w), scale, (RH, RW))
        big.append(b)
        big_hw.append(bhw)
    blurred = hwc(batched_blur(chw(torch.stack(big)), batch.psfs,
                               batch.blurring, hw=np.asarray(big_hw)))
    out = torch.stack([resize_valid(b, bhw, s, (Hb, Wb))
                       for b, bhw, s in zip(blurred, big_hw, hw)])
    keep = batch.blurring.bool().to(out.device)[:, None, None, None]
    return torch.where(keep, out, batch.images)


def _labels(batch, lehe: bool) -> torch.Tensor:
    if lehe:
        return estimator_label_lehe(batch.blurring, batch.param_index,
                                    batch.fraction_index, batch.est_label)
    return estimator_label(batch.blurring, batch.param_index,
                           batch.fraction_index)


def make_estimator_train_step(classifier, schedule: Callable[[int], float],
                              bucket: Tuple[int, int], lehe: bool = False,
                              label_smoothing: float = 0.0,
                              add_noise: bool = False,
                              noise_level: float = 0.001,
                              add_block: bool = False, add_jpeg: bool = False,
                              quantize: bool = False,
                              resize_images: bool = False,
                              crop_images: bool = False):
    """The estimator's train step ``(state, batch, generator=None,
    corruption_draws=None) -> (state, {"loss", "top1"})`` (:131) for
    ``classifier`` (the model in ``state``, BatchNorms in ``train`` mode),
    at the model bucket ``bucket``; the optimizer's learning rate follows
    ``schedule``. ``generator`` feeds the corruptions unless
    ``corruption_draws`` replaces their draws. The running statistics
    move in place.

    Made under a process group, the classifier runs in its
    ``DistributedDataParallel``: the loss is a mean over equal batches on
    every process, so DDP's average of the gradients is the global
    batch's, and the metrics are the global batch's means."""
    from detectinblur_tpu_torch.train.engine import images01, to_device
    from detectinblur_tpu_torch.train.state import TrainState

    ddp = data_parallel(classifier)

    def step(state, batch, generator: Optional[torch.Generator] = None,
             corruption_draws: Optional[CorruptionDraws] = None):
        if state.model is not classifier:
            raise ValueError("the state holds another model")
        batch = images01(to_device(batch, classifier.device))
        images = blur_batch_images(batch, resize_images)
        images = apply_corruptions(images, add_noise, noise_level, add_block,
                                   add_jpeg, generator, corruption_draws,
                                   quantize=quantize)
        imgs, _ = preprocess_batch(images, batch.hw, bucket,
                                   crop_images=crop_images)
        labels = _labels(batch, lehe)
        with training_mode(classifier):
            logits = classifier(imgs) if ddp is None else ddp(
                lambda m: m(imgs))
        nc = logits.shape[-1]
        target = F.one_hot(labels, nc).float()
        if label_smoothing > 0:
            target = target * (1 - label_smoothing) + label_smoothing / nc
        loss = -(target * F.log_softmax(logits, dim=-1)).sum(-1).mean()
        top1 = (logits.argmax(-1) == labels).float().mean()
        optimizer = state.optimizer
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = schedule(state.step)
        optimizer.step()
        metrics = {"loss": loss.detach(), "top1": top1}
        if ddp is not None:
            metrics = {k: v / process_count()
                       for k, v in sum_metrics(metrics).items()}
        return TrainState(state.step + 1, classifier, optimizer), metrics

    return step


def make_estimator_eval_step(classifier, bucket: Tuple[int, int],
                             lehe: bool = False, resize_images: bool = False,
                             crop_images: bool = False):
    """The estimator's eval step ``batch -> {"pred", "label", "top2_hit"}``
    (:183): the blur as in training, no corruptions, BatchNorm on the
    running statistics (``eval`` mode), top-1 and top-2."""
    from detectinblur_tpu_torch.train.engine import images01, to_device

    @torch.no_grad()
    def step(batch):
        batch = images01(to_device(batch, classifier.device))
        images = blur_batch_images(batch, resize_images)
        imgs, _ = preprocess_batch(images, batch.hw, bucket,
                                   crop_images=crop_images)
        with bn_mode(classifier, "eval"):
            logits = classifier(imgs)
        labels = _labels(batch, lehe)
        top2 = logits.topk(2, dim=-1).indices
        return {"pred": logits.argmax(-1), "label": labels,
                "top2_hit": (top2 == labels[:, None]).any(dim=1)}

    return step
