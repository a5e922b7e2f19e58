"""Carry Faster R-CNN weights into the port's state dict.

``params_from_torchvision`` maps a torchvision ``fasterrcnn_resnet50_fpn``
state dict (a released ``.pth``, or the reference's ``{model: ...}``
checkpoint read by ``load_torch_state_dict``) straight onto the port, as
``detectinblur_tpu/utils/torch_convert.py:73`` maps it onto the JAX tree:
FrozenBatchNorm folded into (scale, bias) with eps 0 as ``_fold_frozen_bn``
(:45) does, or, with ``frozen_bn=False``, the BatchNorm kept unfolded for a
``bn_mode`` model (gamma and beta as its scale and bias, the running
statistics with ``num_batches_tracked`` set to ``num_batches``, :62-70 and
:165-190); both torchvision key spellings (``inner_blocks.0`` /
``inner_blocks.0.0``, ``rpn.head.conv`` / ``rpn.head.conv.0.0``) accepted.

``params_from_jax`` maps the tree that ``detectinblur_tpu``'s
``FasterRCNN.init`` or its torchvision converter produces (top-level keys
``backbone`` / ``rpn_head`` / ``box_head`` / ``box_predictor``), with
numpy leaves. The port's modules
are named after that tree, so each leaf maps by its path:

  * conv ``kernel`` HWIO -> ``weight`` OIHW,
  * Dense ``kernel`` [in, out] -> ``weight`` [out, in],
  * ``bias`` and the BatchNorm ``scale``/``bias`` pairs copied as they are,
  * with ``batch_stats`` (a ``bn_mode`` model's running statistics), each
    ``mean`` / ``var`` / ``num_batches_tracked`` leaf to the
    ``running_mean`` / ``running_var`` / ``num_batches_tracked`` buffer.

The single-map detectors (``models/backbones.py``) take a torchvision
ImageNet classifier's torso through ``torso_from_torchvision``
(mobilenet_v2 with its running statistics, or a resnet trunk), and a JAX
``SingleMapFasterRCNN`` tree through ``params_from_jax(...,
backbone=...)``.

The same two routes serve the blur estimator (``ResNetClassifier``):
``classifier_from_torchvision`` takes a torchvision resnet18 with its
BatchNorm unfolded and, as the reference replaces ``fc`` by a fresh head,
leaves ``fc`` out unless asked (JAX ``convert_resnet_classifier_state_dict``,
utils/torch_convert.py:298); ``classifier_params_from_jax`` maps the JAX
classifier's ``params`` and ``batch_stats``. ``deepdeblur_from_torch``
maps a DeepDeblur-PyTorch MSResNet checkpoint onto the port's
``MSResNet`` (JAX ``convert_deepdeblur_state_dict``, models/deblur.py:153):
``body_models`` stored fine-first, ``conv_end_models.{s}.uppath.0`` the
up-convs, the scale and block counts inferred.

Keys and shapes are checked strictly against the port's module tree: a
missing key, an extra key or a wrong shape raises.
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from detectinblur_tpu_torch.models.resnet import RESNET_SPECS, Bottleneck


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "."))
        else:
            out[path] = np.asarray(v)
    return out


def _leaf(key: str, value: np.ndarray):
    head, _, name = key.rpartition(".")
    if name == "kernel":
        if value.ndim == 4:
            return f"{head}.weight", np.transpose(value, (3, 2, 0, 1))
        if value.ndim == 2:
            return f"{head}.weight", np.transpose(value)
        raise ValueError(f"{key}: kernel of rank {value.ndim}")
    return key, value


def expected_shapes(num_classes: int = 91, with_bn_stats: bool = False
                    ) -> Dict[str, torch.Size]:
    """Key -> shape of the port's FasterRCNN state dict, with the running
    statistics of a ``bn_mode`` backbone when ``with_bn_stats`` (built on
    the ``meta`` device, so nothing is allocated)."""
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
    )

    model = FasterRCNN(FasterRCNNConfig(
        num_classes=num_classes, precision="highest",
        bn_mode="eval" if with_bn_stats else None), device="meta")
    return {k: v.shape for k, v in model.state_dict().items()}


def _checked(sd: Dict[str, torch.Tensor], num_classes: int,
             with_bn_stats: bool = False) -> Dict[str, torch.Tensor]:
    return _check_shapes(sd, expected_shapes(num_classes, with_bn_stats))


def _meta_shapes(module) -> Dict[str, torch.Size]:
    return {k: v.shape for k, v in module.state_dict().items()}


def _check_shapes(sd: Dict[str, torch.Tensor],
                  want: Mapping[str, torch.Size]) -> Dict[str, torch.Tensor]:
    """``sd`` if it has exactly the keys of ``want`` with those shapes;
    else ``KeyError`` (keys) or ``ValueError`` (shapes)."""
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"param tree mismatch: missing={missing[:5]} "
                       f"extra={extra[:5]}")
    bad = [(k, tuple(sd[k].shape), tuple(want[k])) for k in sd
           if sd[k].shape != want[k]]
    if bad:
        raise ValueError(f"shape mismatches: {bad[:5]}")
    return sd


_STAT_NAMES = {"mean": "running_mean", "var": "running_var",
               "num_batches_tracked": "num_batches_tracked"}


def single_map_shapes(backbone: str, num_classes: int = 91,
                      with_bn_stats: bool = False) -> Dict[str, torch.Size]:
    """Key -> shape of the port's ``SingleMapFasterRCNN`` state dict for
    ``backbone``; a resnet torso with ``with_bn_stats`` has
    ``AdaptiveBatchNorm``s (built on ``meta``)."""
    from detectinblur_tpu_torch.models.backbones import (
        SingleMapConfig,
        SingleMapFasterRCNN,
    )

    return _meta_shapes(SingleMapFasterRCNN(SingleMapConfig(
        backbone, num_classes=num_classes, precision="highest",
        bn_mode="eval" if with_bn_stats and backbone != "mobile_net"
        else None), device="meta"))


def params_from_jax(tree: Mapping, num_classes: int = 91,
                    batch_stats: Optional[Mapping] = None,
                    backbone: Optional[str] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves), and for a model with BatchNorm
    statistics its ``batch_stats`` tree, -> float32 state dict for the
    port's ``FasterRCNN``, or with ``backbone`` for its
    ``SingleMapFasterRCNN`` of that torso (JAX ``SingleMapFasterRCNN.init``
    and ``init_stats``; a mobile_net tree always has statistics). Raises
    ``KeyError`` on missing or extra keys and ``ValueError`` on a shape
    mismatch."""
    sd = _from_jax(tree, batch_stats)
    if backbone is not None:
        return _check_shapes(sd, single_map_shapes(
            backbone, num_classes, batch_stats is not None))
    return _checked(sd, num_classes, batch_stats is not None)


def _from_jax(tree: Mapping, batch_stats: Optional[Mapping]
              ) -> Dict[str, torch.Tensor]:
    sd = {}
    for key, value in _flatten(tree).items():
        name, arr = _leaf(key, value)
        sd[name] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    for key, value in _flatten(batch_stats or {}).items():
        head, _, leaf = key.rpartition(".")
        sd[f"{head}.{_STAT_NAMES[leaf]}"] = torch.from_numpy(
            np.array(value, np.float32, order="C"))
    return sd


def _classifier_shapes(arch: str, num_classes: int) -> Dict[str, torch.Size]:
    from detectinblur_tpu_torch.models.classifier import ResNetClassifier

    return _meta_shapes(ResNetClassifier(arch, num_classes, device="meta"))


def classifier_params_from_jax(tree: Mapping, batch_stats: Mapping,
                               arch: str = "resnet18", num_classes: int = 16
                               ) -> Dict[str, torch.Tensor]:
    """The JAX ``ResNetClassifier``'s ``params`` and ``batch_stats`` trees
    (numpy leaves) -> float32 state dict for the port's
    ``ResNetClassifier``, checked strictly as ``params_from_jax``."""
    return _check_shapes(_from_jax(tree, batch_stats),
                         _classifier_shapes(arch, num_classes))


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``.pth`` as a state dict of CPU tensors: a bare state dict,
    or the reference's checkpoint ``{model, optimizer, lr_scheduler, args,
    epoch}`` (train.py:332-339), whose ``model`` entry is taken. Read with
    ``weights_only=True``; the reference's ``args`` namespace is the one
    class allowed besides tensors and containers."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    return {k: v.detach().cpu() for k, v in obj.items()}


def params_from_torchvision(sd: Mapping, num_classes: int = 91,
                            frozen_bn: bool = True, num_batches: float = 0.0
                            ) -> Dict[str, torch.Tensor]:
    """A torchvision ``fasterrcnn_resnet50_fpn`` state dict (tensors or
    numpy arrays) -> float32 state dict for the port's ``FasterRCNN``:
    FrozenBatchNorm folded, or with ``frozen_bn=False`` the state dict of
    a ``bn_mode`` model (``num_batches`` in every ``num_batches_tracked``).
    Raises ``KeyError`` on a missing key or one left unused, and
    ``ValueError`` on a shape mismatch. The FrozenBN fold is computed in
    numpy float32 as the JAX converter computes it, so both packages get
    the same bits."""
    m = _Mapper(sd, frozen_bn, num_batches)
    copy = m.copy
    m.trunk("backbone.body", "backbone.body", "resnet50")
    for i in range(4):
        for ours, theirs in (("inner", "inner_blocks"), ("layer", "layer_blocks")):
            for k in ("weight", "bias"):
                copy(f"backbone.fpn.{ours}_{i}.{k}",
                     f"backbone.fpn.{theirs}.{i}.{k}",
                     f"backbone.fpn.{theirs}.{i}.0.{k}")
    for k in ("weight", "bias"):
        copy(f"rpn_head.conv.{k}", f"rpn.head.conv.{k}",
             f"rpn.head.conv.0.0.{k}")
        for head in ("cls_logits", "bbox_pred"):
            copy(f"rpn_head.{head}.{k}", f"rpn.head.{head}.{k}")
        for fc in ("fc6", "fc7"):
            copy(f"box_head.{fc}.{k}", f"roi_heads.box_head.{fc}.{k}")
        for head in ("cls_score", "bbox_pred"):
            copy(f"box_predictor.{head}.{k}",
                 f"roi_heads.box_predictor.{head}.{k}")
    return _checked(m.result(), num_classes, not frozen_bn)


class _Mapper:
    """Carries named arrays of a source state dict into the port's names,
    remembering which source keys were used; ``result`` raises on one
    left unused."""

    def __init__(self, sd: Mapping, frozen_bn: bool = False,
                 num_batches: float = 0.0, ignore: Tuple[str, ...] = ()):
        self.src = {k: np.asarray(v.detach().cpu()
                                  if isinstance(v, torch.Tensor) else v)
                    for k, v in sd.items() if not k.startswith(ignore)}
        self.frozen_bn, self.num_batches = frozen_bn, num_batches
        self.used = set()
        self.out: Dict[str, np.ndarray] = {}

    def get(self, *names):
        for n in names:
            if n in self.src:
                self.used.add(n)
                return self.src[n]
        raise KeyError(f"none of {names} in the state dict")

    def copy(self, dst, *names):
        self.out[dst] = self.get(*names)

    def fold(self, dst, prefix):
        """A torchvision BatchNorm: folded into FrozenBatchNorm's (scale,
        bias) with eps 0, or kept unfolded for an ``AdaptiveBatchNorm``
        (gamma and beta, the running statistics, ``num_batches``)."""
        gamma, beta, mean, var = (self.get(f"{prefix}.{k}") for k in (
            "weight", "bias", "running_mean", "running_var"))
        out = self.out
        if f"{prefix}.num_batches_tracked" in self.src:
            self.used.add(f"{prefix}.num_batches_tracked")
        if not self.frozen_bn:
            out[f"{dst}.scale"], out[f"{dst}.bias"] = gamma, beta
            out[f"{dst}.running_mean"], out[f"{dst}.running_var"] = mean, var
            out[f"{dst}.num_batches_tracked"] = np.float32(self.num_batches)
            return
        scale = gamma / np.sqrt(var + 0.0)
        out[f"{dst}.scale"] = scale
        out[f"{dst}.bias"] = beta - mean * scale

    def trunk(self, dst: str, src: str, arch: str) -> None:
        """A torchvision ResNet trunk under the prefix ``src`` ("" for a
        classifier's top level) onto the port's at ``dst`` (``layer1.0`` ->
        ``layer1_0``, ``downsample.0`` -> ``downsample_0``)."""
        block, layers = RESNET_SPECS[arch]
        convs = (1, 2, 3) if block is Bottleneck else (1, 2)
        src = f"{src}." if src else ""
        self.copy(f"{dst}.conv1.weight", f"{src}conv1.weight")
        self.fold(f"{dst}.bn1", f"{src}bn1")
        for li, n_blocks in enumerate(layers, start=1):
            for b in range(n_blocks):
                p, q = f"{dst}.layer{li}_{b}", f"{src}layer{li}.{b}"
                for c in convs:
                    self.copy(f"{p}.conv{c}.weight", f"{q}.conv{c}.weight")
                    self.fold(f"{p}.bn{c}", f"{q}.bn{c}")
                if f"{q}.downsample.0.weight" in self.src:
                    self.copy(f"{p}.downsample_0.weight",
                              f"{q}.downsample.0.weight")
                    self.fold(f"{p}.downsample_1", f"{q}.downsample.1")

    def result(self) -> Dict[str, torch.Tensor]:
        unused = sorted(set(self.src) - self.used)
        if unused:
            raise KeyError(f"state dict keys left unused: {unused[:5]}")
        return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
                for k, v in self.out.items()}


def torso_from_torchvision(sd: Mapping, backbone: str,
                           frozen_bn: bool = True, num_batches: float = 0.0
                           ) -> Dict[str, torch.Tensor]:
    """A torchvision ImageNet classifier's state dict -> the ``backbone.*``
    state dict of the port's ``SingleMapFasterRCNN`` torso (its heads stay
    the caller's): JAX ``convert_mobilenet_v2_features`` (:196) and
    ``convert_resnet_trunk_state_dict`` (:243).

    ``mobile_net``: ``features.0`` the stem, ``features.1..17`` the
    inverted residuals (block 1 without the expand conv), ``features.18``
    the head; BatchNorms unfolded with their running statistics and
    ``num_batches`` in every count; the ``classifier`` is skipped. A
    resnet (``resnet50``, ...): the trunk, ``fc`` skipped, BatchNorm
    folded into FrozenBatchNorm's affine (eps 0), or unfolded with
    ``frozen_bn=False`` for a ``bn_mode`` torso. Strict otherwise: a
    missing, unused or misshapen key raises."""
    if backbone == "mobile_net":
        m = _Mapper(sd, num_batches=num_batches, ignore=("classifier.",))

        def conv_bn(dst, conv, bn):
            m.copy(f"backbone.{dst}_conv.weight", f"{conv}.weight")
            m.fold(f"backbone.{dst}_bn", bn)

        conv_bn("stem", "features.0.0", "features.0.1")
        for i in range(1, 18):
            p, q = f"block{i}", f"features.{i}.conv"
            if f"{q}.1.0.weight" in m.src:      # expand, depthwise, project
                conv_bn(f"{p}.expand", f"{q}.0.0", f"{q}.0.1")
                conv_bn(f"{p}.depthwise", f"{q}.1.0", f"{q}.1.1")
                conv_bn(f"{p}.project", f"{q}.2", f"{q}.3")
            else:                               # block 1: depthwise, project
                conv_bn(f"{p}.depthwise", f"{q}.0.0", f"{q}.0.1")
                conv_bn(f"{p}.project", f"{q}.1", f"{q}.2")
        conv_bn("head", "features.18.0", "features.18.1")
        with_stats = True
    elif backbone.startswith("res"):
        m = _Mapper(sd, frozen_bn, num_batches, ignore=("fc.",))
        m.trunk("backbone", "", backbone)
        with_stats = not frozen_bn
    else:
        raise ValueError(f"no torchvision torso converter for {backbone!r}")
    want = {k: v for k, v in single_map_shapes(backbone,
                                               with_bn_stats=with_stats).items()
            if k.startswith("backbone.")}
    return _check_shapes(m.result(), want)


def classifier_from_torchvision(sd: Mapping, arch: str = "resnet18",
                                num_classes: int = 16,
                                num_batches: float = 0.0,
                                include_fc: bool = False
                                ) -> Dict[str, torch.Tensor]:
    """A torchvision resnet classifier state dict -> float32 state dict of
    the port's ``ResNetClassifier`` trunk (``body.*``), BatchNorm unfolded
    with ``num_batches`` in every ``num_batches_tracked``; with
    ``include_fc`` the file's ``fc`` too (it must have ``num_classes``
    rows). Without it the file's ``fc`` is skipped and the result lacks
    ``fc.*``, which the caller's fresh head supplies. Strict otherwise:
    a missing, unused or misshapen key raises."""
    m = _Mapper(sd, num_batches=num_batches,
                ignore=() if include_fc else ("fc.",))
    m.trunk("body", "", arch)
    if include_fc:
        m.copy("fc.weight", "fc.weight")
        m.copy("fc.bias", "fc.bias")
    want = _classifier_shapes(arch, num_classes)
    if not include_fc:
        want = {k: v for k, v in want.items() if not k.startswith("fc.")}
    return _check_shapes(m.result(), want)


def deepdeblur_from_torch(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A DeepDeblur-PyTorch MSResNet checkpoint -> float32 state dict of
    the port's ``MSResNet``: ``body_models.{s}.body.0`` the head of scale
    ``s`` (0 the finest), ``.body.{b + 1}.body.0`` / ``.body.2`` the convs
    of block ``b``, ``.body.{n_blocks + 1}`` the tail, and
    ``conv_end_models.{s}.uppath.0`` the up-conv of scale ``s``. Strict:
    a missing, unused or misshapen key raises."""
    from detectinblur_tpu_torch.models.deblur import MSResNet

    m = _Mapper(sd)
    n_scales = 1 + max(int(k.split(".")[1]) for k in m.src
                       if k.startswith("body_models."))
    n_blocks = max(int(k.split(".")[3]) for k in m.src
                   if k.startswith("body_models.0.body.")) - 1

    def conv(dst, src):
        for k in ("weight", "bias"):
            m.copy(f"{dst}.{k}", f"{src}.{k}")

    for s in range(n_scales):
        body = f"body_models.{s}.body"
        conv(f"scale{s}.head", f"{body}.0")
        for b in range(n_blocks):
            conv(f"scale{s}.block{b}.conv0", f"{body}.{b + 1}.body.0")
            conv(f"scale{s}.block{b}.conv1", f"{body}.{b + 1}.body.2")
        conv(f"scale{s}.tail", f"{body}.{n_blocks + 1}")
        if s > 0:
            conv(f"up{s}", f"conv_end_models.{s}.uppath.0")
    out = m.result()
    head = out["scale0.head.weight"]
    with torch.device("meta"):
        net = MSResNet(n_scales, head.shape[0], head.shape[-1], n_blocks)
    return _check_shapes(out, _meta_shapes(net))
