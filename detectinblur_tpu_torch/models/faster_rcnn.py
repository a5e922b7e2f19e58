"""Faster R-CNN ResNet50-FPN inference and training loss in torch.

Port of ``detectinblur_tpu/models/faster_rcnn.py`` (``FasterRCNNConfig``
:48, ``Detections`` :71, ``FasterRCNN.predict`` :210, ``FasterRCNN.loss``
:277):

  raw bucketed images [B, Hb, Wb, 3] + valid sizes
    -> normalize + resize into the model bucket
    -> ResNet50-FPN (P2..P6)
    -> RPN -> RoIAlign (the CUDA kernel on the card, the plain version on
       the CPU) -> TwoMLPHead + predictor -> postprocess -> boxes rescaled
       to input coordinates.

The stages shared with the single-map detectors (``models/backbones.py``)
live in ``TwoStageDetector``; a detector brings its backbone's
``features``, its anchors and its pooling. ``predict`` is the composition
of the public stage methods
``preprocess``, ``features``, ``propose``, ``pool`` and ``detect``, which
a caller may also run one by one (the smoke script times them so). Each
runs inside a ``torch.profiler.record_function`` range (``predict.rpn``
and so on), so a profiler trace of any caller shows where its time goes.

``loss`` runs the same stages in training form (train top-k sizes, anchor
and roi sampling, RoIAlign through the differentiable kernel pair) and
returns the four torchvision losses; it batches over the images where the
JAX version vmaps.

Precision is a config field (``utils/device.py``): ``highest`` keeps every
activation in float32 with TF32 off; ``default`` computes the backbone and
heads in bfloat16. Parameters are float32 in both (each layer casts its
weights to its input's dtype).

The paper's in-detector remedies are config fields and arguments, as in
JAX: ``warp_internally`` warps the preprocessed images with each image's
(theta, lambda1, lambda2) before the backbone and every FPN level back
with (theta, 1/lambda1, 1/lambda2) after it (``_features`` :146-171);
``bn_mode`` makes the backbone's BatchNorms ``AdaptiveBatchNorm``s in that
mode; ``means`` / ``stds`` normalize each image with its own statistics.
``loss`` writes the running-statistics update of the ``train`` and
``acclimation`` modes into the BatchNorm buffers; ``predict`` normalizes
as the mode says and writes nothing, as JAX drops the update there.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from detectinblur_tpu_torch.models.batchnorm import training_mode
from detectinblur_tpu_torch.models.detection_transform import (
    preprocess_batch,
    resize_boxes,
)
from detectinblur_tpu_torch.models.resnet import ResNetFPN
from detectinblur_tpu_torch.models.roi_heads import (
    BoxHeadConfig,
    FastRCNNPredictor,
    TwoMLPHead,
    fastrcnn_loss,
    postprocess_detections,
    select_training_samples,
)
from detectinblur_tpu_torch.models.rpn import (
    RPNConfig,
    RPNHead,
    level_anchors,
    rpn_loss,
    run_rpn,
)
from detectinblur_tpu_torch.ops.roi_align_cuda import multiscale_roi_align_cuda
from detectinblur_tpu_torch.ops.warp import squint_warp
from detectinblur_tpu_torch.parallel.dist import all_reduce_sum, distributed
from detectinblur_tpu_torch.utils.device import (
    DEFAULT_PRECISION,
    act_dtype,
    check_precision,
    resolve_device,
    set_fp32_math,
)


class FasterRCNNConfig(NamedTuple):
    num_classes: int = 91
    min_size: int = 800
    max_size: int = 1333
    rpn: RPNConfig = RPNConfig()
    box: BoxHeadConfig = BoxHeadConfig()
    precision: str = DEFAULT_PRECISION
    warp_internally: bool = False
    # None = FrozenBatchNorm; else the AdaptiveBatchNorm mode (train, eval,
    # acclimation, mode_one) of every BatchNorm in the backbone.
    bn_mode: Optional[str] = None


class Detections(NamedTuple):
    boxes: torch.Tensor     # [B, D, 4] in input (pre-resize) valid coords
    scores: torch.Tensor    # [B, D]
    labels: torch.Tensor    # [B, D]
    valid: torch.Tensor     # [B, D]


class LossDraws(NamedTuple):
    """The uniform keys of the loss's two balanced samplers, one row per
    image: ``rpn`` = (u_pos, u_neg), each [B, sum_A]; ``roi`` = (u_pos,
    u_neg), each [B, P + G] (P the train post-NMS proposal count)."""
    rpn: Tuple[torch.Tensor, torch.Tensor]
    roi: Tuple[torch.Tensor, torch.Tensor]


class TwoStageDetector(nn.Module):
    """The stages that every Faster R-CNN of the port shares: preprocess,
    propose, detect, and ``predict`` / ``loss`` over them. A detector
    gives ``cfg`` (``precision``, ``min_size``, ``max_size``, ``rpn``,
    ``box``), the submodules ``backbone`` / ``rpn_head`` / ``box_head`` /
    ``box_predictor``, and its own ``features``, ``level_anchors`` and
    ``pool``; ``_training_torso`` is the backbone's state while ``loss``
    runs it."""

    @property
    def device(self) -> torch.device:
        return self.rpn_head.conv.weight.device

    def _training_torso(self):
        return training_mode(self.backbone)

    # ------------------------------------------------------------- stages
    def preprocess(self, images: torch.Tensor, hw, bucket: Tuple[int, int],
                   means: Optional[torch.Tensor] = None,
                   stds: Optional[torch.Tensor] = None):
        """-> (batched [B, Ho, Wo, 3] float32, new_hw [B, 2])."""
        return preprocess_batch(images, hw, bucket, self.cfg.min_size,
                                self.cfg.max_size, means=means, stds=stds)

    def propose(self, feats, new_hw: torch.Tensor):
        """-> (proposals [B, P, 4], valid [B, P])."""
        out = run_rpn(self.rpn_head, feats, new_hw, self.cfg.rpn,
                      anchors=self.level_anchors(feats))
        return out.proposals, out.proposal_valid

    def detect(self, pooled: torch.Tensor, proposals: torch.Tensor,
               valid: torch.Tensor, new_hw: torch.Tensor,
               hw) -> Detections:
        """Box head + predictor + postprocess + rescale to input coords."""
        B, P = proposals.shape[:2]
        x = self.box_head(pooled.reshape(B * P, *pooled.shape[2:]))
        logits, deltas = self.box_predictor(x)
        boxes, scores, labels, det_valid = postprocess_detections(
            logits.reshape(B, P, -1), deltas.reshape(B, P, -1), proposals,
            valid, new_hw, self.cfg.box)
        orig_hw = torch.as_tensor(hw, device=boxes.device)
        boxes = resize_boxes(boxes, new_hw, orig_hw)
        return Detections(boxes, scores, labels, det_valid)

    # ---------------------------------------------------------- inference
    @torch.no_grad()
    def predict(self, images: torch.Tensor, hw, bucket: Tuple[int, int],
                means: Optional[torch.Tensor] = None,
                stds: Optional[torch.Tensor] = None,
                thetas: Optional[torch.Tensor] = None,
                lam1s: Optional[torch.Tensor] = None,
                lam2s: Optional[torch.Tensor] = None) -> Detections:
        """images [B, Hb0, Wb0, 3] raw 0..1 with the valid region at the
        top-left, ``hw`` [B, 2] valid sizes (a host array), ``bucket`` the
        static model bucket -> fixed-size ``Detections``. ``means`` /
        ``stds`` [B, 3] and ``thetas``, ``lam1s``, ``lam2s`` [B] are the
        remedies' per-image inputs."""
        with record_function("predict.preprocess"):
            batched, new_hw = self.preprocess(images.to(self.device), hw,
                                              bucket, means, stds)
        with record_function("predict.backbone"):
            feats = self.features(batched, thetas, lam1s, lam2s)
        with record_function("predict.rpn"):
            proposals, valid = self.propose(feats, new_hw)
        with record_function("predict.roi_align"):
            pooled = self.pool(feats, proposals, valid)
        with record_function("predict.head_postprocess"):
            return self.detect(pooled, proposals, valid, new_hw, hw)

    def forward(self, *args, **kwargs) -> Detections:
        """``predict``: ``torch.func.functional_call`` calls ``forward``,
        and the ensemble runs each specialist's weights through it."""
        return self.predict(*args, **kwargs)

    # ------------------------------------------------------------ training
    def loss(self, images: torch.Tensor, hw, gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_valid: torch.Tensor,
             bucket: Tuple[int, int],
             generator: Optional[torch.Generator] = None,
             draws: Optional[LossDraws] = None,
             means: Optional[torch.Tensor] = None,
             stds: Optional[torch.Tensor] = None,
             thetas: Optional[torch.Tensor] = None,
             lam1s: Optional[torch.Tensor] = None,
             lam2s: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """The four torchvision training losses of a batch, with a graph
        back to the parameters.

        ``images`` [B, Hb0, Wb0, 3] raw 0..1, ``hw`` [B, 2] valid sizes,
        ``gt_boxes`` [B, G, 4] in input coordinates with ``gt_labels`` and
        ``gt_valid`` [B, G]. The samplers draw from ``generator`` (on the
        model's device) or take ``draws``. Normalized as the JAX version
        (and torchvision): RPN sums over the batch's sampled anchors, head
        sums over its sampled rois; under a process group each process's
        sums are divided by the counts of every process's batch, so the
        losses summed over the processes are the global batch's (JAX's
        mean over a sharded batch). ``means``, ``stds`` and the warp's as in
        ``predict``; the BatchNorms of the ``train`` and ``acclimation``
        modes update their running statistics."""
        cfg = self.cfg
        device = self.device
        B = images.shape[0]
        batched, new_hw = self.preprocess(images.to(device), hw, bucket,
                                          means, stds)
        gt = resize_boxes(gt_boxes.to(device).float(),
                          torch.as_tensor(hw, device=device), new_hw)
        gt_labels = gt_labels.to(device)
        gt_valid = gt_valid.to(device).bool()

        with self._training_torso():
            feats = self.features(batched, thetas, lam1s, lam2s)
        rpn = run_rpn(self.rpn_head, feats, new_hw, cfg.rpn,
                      anchors=self.level_anchors(feats), training=True)
        rpn_box, rpn_obj, rpn_n = rpn_loss(
            rpn.objectness, rpn.pred_deltas, rpn.anchors, gt, gt_valid,
            cfg.rpn, generator, None if draws is None else draws.rpn)

        rois, roi_labels, reg_targets, roi_valid = select_training_samples(
            rpn.proposals, rpn.proposal_valid, gt, gt_labels, gt_valid,
            cfg.box, generator, None if draws is None else draws.roi)
        # Unsampled slots are zeroed before pooling; their cotangents are
        # exactly zero, and the backward kernel skips them.
        pooled = self.pool(feats, rois, roi_valid)
        S = rois.shape[1]
        x = self.box_head(pooled.reshape(B * S, *pooled.shape[2:]))
        logits, deltas = self.box_predictor(x)
        ce_sum, box_sum, n = fastrcnn_loss(
            logits.reshape(B, S, -1), deltas.reshape(B, S, -1), roi_labels,
            reg_targets)
        n_rpn, n_tot = rpn_n.sum(), n.sum()
        if distributed():
            # Each process's sums over the global batch's counts: summed
            # over the processes, they are the global batch's losses.
            n_rpn, n_tot = all_reduce_sum(torch.stack([n_rpn, n_tot]))
        n_rpn, n_tot = n_rpn.clamp(min=1), n_tot.clamp(min=1)
        return {
            "loss_objectness": rpn_obj.sum() / n_rpn,
            "loss_rpn_box_reg": rpn_box.sum() / n_rpn,
            "loss_classifier": ce_sum.sum() / n_tot,
            "loss_box_reg": box_sum.sum() / n_tot,
        }


def reset_box_heads(detector: nn.Module, generator: torch.Generator) -> None:
    """torch nn.Linear's default init of the box head and predictor,
    drawn from ``generator`` (the JAX TORCH_LINEAR initialisers)."""
    with torch.no_grad():
        for m in (*detector.box_head.children(),
                  *detector.box_predictor.children()):
            bound = 1.0 / m.in_features ** 0.5
            nn.init.kaiming_uniform_(m.weight, a=5 ** 0.5, generator=generator)
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)


class FasterRCNN(TwoStageDetector):
    """Parameters live in the submodules ``backbone`` / ``rpn_head`` /
    ``box_head`` / ``box_predictor``, named as the JAX param tree's top
    level so ``utils/convert.params_from_jax`` maps onto them.

    The model is built on ``device`` (CUDA unless the caller asks for
    another), initialised from a ``torch.Generator`` seeded with ``seed``
    as the JAX initialisers do: kaiming-normal fan_out trunk, kaiming
    uniform a=1 FPN, N(0, 0.01) RPN head, torch Linear defaults for the
    box head and predictor."""

    def __init__(self, config: FasterRCNNConfig = FasterRCNNConfig(),
                 device=None, seed: int = 0):
        super().__init__()
        check_precision(config.precision)
        self.cfg = config
        device = resolve_device(device)
        # Built on the CPU (or on `meta`, for shapes only) and moved after
        # the seeded initialisation, so the weights do not depend on the
        # device.
        with torch.device("meta" if device.type == "meta" else "cpu"):
            self.backbone = ResNetFPN(act_dtype=act_dtype(config.precision),
                                      bn_mode=config.bn_mode)
            self.rpn_head = RPNHead()
            self.box_head = TwoMLPHead()
            self.box_predictor = FastRCNNPredictor(
                num_classes=config.num_classes)
        if device.type != "meta":
            self.reset_parameters(torch.Generator().manual_seed(seed))
        self._anchors = {}
        if device.type == "cuda":
            set_fp32_math()
        self.to(device=device, memory_format=torch.channels_last)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.backbone.reset_parameters(generator)
        self.rpn_head.reset_parameters(generator)
        reset_box_heads(self, generator)

    @property
    def has_bn(self) -> bool:
        """The backbone has BatchNorms with running statistics."""
        return self.cfg.bn_mode is not None

    # ------------------------------------------------------------- stages
    def features(self, batched: torch.Tensor,
                 thetas: Optional[torch.Tensor] = None,
                 lam1s: Optional[torch.Tensor] = None,
                 lam2s: Optional[torch.Tensor] = None):
        """-> (P2, P3, P4, P5, P6) NHWC in the activation dtype; with
        ``warp_internally``, the images warped by (``thetas``, ``lam1s``,
        ``lam2s``) [B] first and each level warped back after."""
        if not self.cfg.warp_internally:
            return self.backbone(batched)
        if thetas is None or lam1s is None or lam2s is None:
            raise ValueError("a warp_internally model needs thetas, lam1s "
                             "and lam2s")
        t, l1, l2 = (x.to(batched.device) for x in (thetas, lam1s, lam2s))
        feats = self.backbone(squint_warp(batched, t, l1, l2))
        return tuple(squint_warp(f, t, 1.0 / l1, 1.0 / l2) for f in feats)

    def level_anchors(self, feats):
        """``rpn.level_anchors`` for these feature shapes, cached."""
        key = tuple(tuple(f.shape[1:3]) for f in feats)
        if key not in self._anchors:
            self._anchors[key] = level_anchors(feats)
        return self._anchors[key]

    def pool(self, feats, proposals: torch.Tensor, valid: torch.Tensor):
        """RoIAlign of the proposals on P2..P5 -> [B, P, 7, 7, C].

        Invalid slots carry NMS-suppressed boxes whose outputs are masked
        out later; they are zeroed first, as in the JAX version."""
        rois = torch.where(valid[..., None], proposals,
                           torch.zeros_like(proposals))
        # Channels-last levels are contiguous NHWC already (a no-op).
        return multiscale_roi_align_cuda([f.contiguous() for f in feats[:4]],
                                         rois)
