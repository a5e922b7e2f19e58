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

Keys and shapes are checked strictly against the port's module tree: a
missing key, an extra key or a wrong shape raises.
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping, Optional

import numpy as np
import torch

RESNET50_LAYERS = (3, 4, 6, 3)


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
    want = expected_shapes(num_classes, with_bn_stats)
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


def params_from_jax(tree: Mapping, num_classes: int = 91,
                    batch_stats: Optional[Mapping] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves), and for a ``bn_mode`` model its
    ``batch_stats`` tree, -> float32 state dict for the port's
    ``FasterRCNN``. Raises ``KeyError`` on missing or extra keys and
    ``ValueError`` on a shape mismatch."""
    sd = {}
    for key, value in _flatten(tree).items():
        name, arr = _leaf(key, value)
        sd[name] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    for key, value in _flatten(batch_stats or {}).items():
        head, _, leaf = key.rpartition(".")
        sd[f"{head}.{_STAT_NAMES[leaf]}"] = torch.from_numpy(
            np.array(value, np.float32, order="C"))
    return _checked(sd, num_classes, batch_stats is not None)


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
    src = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                         else v) for k, v in sd.items()}
    used = set()

    def get(*names):
        for n in names:
            if n in src:
                used.add(n)
                return src[n]
        raise KeyError(f"none of {names} in the state dict")

    out: Dict[str, np.ndarray] = {}

    def fold(dst, prefix):
        gamma, beta, mean, var = (get(f"{prefix}.{k}") for k in (
            "weight", "bias", "running_mean", "running_var"))
        if not frozen_bn:
            out[f"{dst}.scale"], out[f"{dst}.bias"] = gamma, beta
            out[f"{dst}.running_mean"], out[f"{dst}.running_var"] = mean, var
            out[f"{dst}.num_batches_tracked"] = np.float32(num_batches)
            if f"{prefix}.num_batches_tracked" in src:
                used.add(f"{prefix}.num_batches_tracked")
            return
        scale = gamma / np.sqrt(var + 0.0)
        out[f"{dst}.scale"] = scale
        out[f"{dst}.bias"] = beta - mean * scale

    def copy(dst, *names):
        out[dst] = get(*names)

    body = "backbone.body"
    copy(f"{body}.conv1.weight", f"{body}.conv1.weight")
    fold(f"{body}.bn1", f"{body}.bn1")
    for li, n_blocks in enumerate(RESNET50_LAYERS, start=1):
        for b in range(n_blocks):
            p, q = f"{body}.layer{li}_{b}", f"{body}.layer{li}.{b}"
            for c in (1, 2, 3):
                copy(f"{p}.conv{c}.weight", f"{q}.conv{c}.weight")
                fold(f"{p}.bn{c}", f"{q}.bn{c}")
            if f"{q}.downsample.0.weight" in src:
                copy(f"{p}.downsample_0.weight", f"{q}.downsample.0.weight")
                fold(f"{p}.downsample_1", f"{q}.downsample.1")
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
    unused = sorted(set(src) - used)
    if unused:
        raise KeyError(f"state dict keys left unused: {unused[:5]}")
    return _checked({k: torch.from_numpy(np.array(v, np.float32, order="C"))
                     for k, v in out.items()}, num_classes, not frozen_bn)
