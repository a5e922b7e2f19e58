"""The LEHE estimator-gated specialist ensemble.

Port of ``detectinblur_tpu/models/ensemble.py`` (:24-98). The reference
keeps four detectors and picks one per image in Python (engine.py:194-218,
353-366 of the reference); JAX stacks the four parameter trees and
gathers one by a traced index. Here the four specialists' parameters and
buffers are stacked with ``torch.func.stack_module_state``, one is
gathered by a device index (``index_select``, no host sync for the
choice) and run through the template detector with
``torch.func.functional_call``.

The index comes from the blur estimator on the batch cropped to its
smallest extent (``preprocess_batch(..., crop_images=True)``, as the
reference batches it, engine.py:264): ``clamp(argmax, 0, 3)`` for LEHE's
4 classes, ``estimator_to_model_index_16`` for 16; without an estimator,
from the true blur struct (``model_index_oracle``). Everything before it
is the single-model eval preamble (``train.engine.prepare_eval_batch``:
blur, corruptions, GT expansion, deblur-first, warp parameters). The
eval protocol is batch 1, so one gather per image.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.func import functional_call, stack_module_state
from torch.profiler import record_function

from detectinblur_tpu_torch.models.classifier import (
    ResNetClassifier,
    estimator_to_model_index_16,
    model_index_oracle,
)
from detectinblur_tpu_torch.models.deblur import MSResNet
from detectinblur_tpu_torch.models.detection_transform import preprocess_batch
from detectinblur_tpu_torch.train.engine import (
    BlurBatch,
    remedy_kwargs,
    prepare_eval_batch,
    to_device,
)


class Specialists(NamedTuple):
    """Detectors of one architecture, stacked: ``template`` is the module
    the gathered weights run through; every tensor of ``params`` and
    ``buffers`` has the specialists on its leading axis."""
    template: torch.nn.Module
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]


def stack_specialists(models: Sequence[torch.nn.Module]) -> Specialists:
    """[detector] * N -> ``Specialists`` (the first is the template)."""
    params, buffers = stack_module_state(list(models))
    return Specialists(models[0], params, buffers)


def select_specialist(stacked: Dict[str, torch.Tensor],
                      index: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One specialist's tensors by a 0-d device ``index``."""
    i = index.reshape(1)
    return {k: v.index_select(0, i)[0] for k, v in stacked.items()}


def make_ensemble_predict(model, bucket: Tuple[int, int],
                          estimator: Optional[ResNetClassifier] = None,
                          lehe: bool = True, blur_eval: bool = True,
                          expand_target_boxes: bool = False,
                          use_warp: bool = False,
                          use_custom_norm: bool = False,
                          deblurrer: Optional[MSResNet] = None,
                          add_noise: bool = False, noise_level: float = 0.001,
                          add_block: bool = False, add_jpeg: bool = False,
                          dilate_psf: bool = False):
    """The ensemble's eval step ``(specialists, batch, generator=None,
    dilate_psf_sigma=None, corruption_draws=None) -> (Detections,
    gt_boxes, index)`` at the model bucket ``bucket``, for batch 1:
    ``model`` is the specialists' template (FrozenBatchNorm: stacking
    BatchNorm statistics is not done, as JAX's ensemble has none),
    ``estimator`` the blur estimator (run in the BatchNorm mode it was
    built with, ``eval`` from ``cli.evaluate``) or None for the oracle. ``index`` is
    the chosen specialist, a 0-d tensor on the device."""
    if model.cfg.bn_mode is not None:
        raise ValueError("the ensemble takes FrozenBatchNorm specialists, "
                         f"not bn_mode {model.cfg.bn_mode!r}")

    @torch.no_grad()
    def predict(specialists: Specialists, batch: BlurBatch,
                generator: Optional[torch.Generator] = None,
                dilate_psf_sigma: Optional[torch.Tensor] = None,
                corruption_draws=None):
        if specialists.template is not model:
            raise ValueError("the step was made for another template")
        with record_function("eval.to_device"):
            batch = to_device(batch, model.device)
        with record_function("eval.blur_expand"):
            batch = prepare_eval_batch(
                batch, generator, blur_eval=blur_eval,
                expand_target_boxes=expand_target_boxes,
                precision=model.cfg.precision, add_noise=add_noise,
                noise_level=noise_level, add_block=add_block,
                add_jpeg=add_jpeg, dilate_psf=dilate_psf, use_warp=use_warp,
                dilate_psf_sigma=dilate_psf_sigma,
                corruption_draws=corruption_draws, deblurrer=deblurrer)
        with record_function("ensemble.choose"):
            if estimator is None:
                index = model_index_oracle(batch.blurring, batch.param_index,
                                           batch.fraction_index)[0]
            else:
                imgs, _ = preprocess_batch(batch.images, batch.hw, bucket,
                                           crop_images=True)
                pred = estimator(imgs.to(estimator.device)).argmax(-1)[0]
                index = (pred.clamp(0, 3) if lehe
                         else estimator_to_model_index_16(pred))
            index = index.to(model.device)
            weights = (select_specialist(specialists.params, index),
                       select_specialist(specialists.buffers, index))
        dets = functional_call(
            model, weights, (batch.images, batch.hw, bucket),
            remedy_kwargs(batch, use_warp, use_custom_norm))
        return dets, batch.gt_boxes, index

    return predict
