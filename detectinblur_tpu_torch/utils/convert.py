"""Map a JAX-layout Faster R-CNN param tree onto the port's state dict.

The input is the tree ``detectinblur_tpu``'s ``FasterRCNN.init`` or its
torchvision converter produces (top-level keys ``backbone`` / ``rpn_head``
/ ``box_head`` / ``box_predictor``), with numpy leaves. The port's modules
are named after that tree, so each leaf maps by its path:

  * conv ``kernel`` HWIO -> ``weight`` OIHW,
  * Dense ``kernel`` [in, out] -> ``weight`` [out, in],
  * ``bias`` and the FrozenBN ``scale``/``bias`` pairs copied as they are.

Keys and shapes are checked strictly against the port's module tree: a
missing key, an extra key or a wrong shape raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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


def expected_shapes(num_classes: int = 91) -> Dict[str, torch.Size]:
    """Key -> shape of the port's FasterRCNN state dict (built on the
    ``meta`` device, so nothing is allocated)."""
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
    )

    model = FasterRCNN(FasterRCNNConfig(num_classes=num_classes,
                                        precision="highest"), device="meta")
    return {k: v.shape for k, v in model.state_dict().items()}


def params_from_jax(tree: Mapping, num_classes: int = 91
                    ) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) -> float32 state dict for the port's
    ``FasterRCNN``. Raises ``KeyError`` on missing or extra keys and
    ``ValueError`` on a shape mismatch."""
    sd = {}
    for key, value in _flatten(tree).items():
        name, arr = _leaf(key, value)
        sd[name] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    want = expected_shapes(num_classes)
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
