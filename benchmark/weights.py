"""A cell's weights from its seed: every tensor of the detector's state
dict, made on the device in two large draws (one normal, one uniform)
from a ``torch.Generator``, then scaled tensor by tensor.

Rules, first match in the configuration's ``init.rules`` (by substring of
the name), else by kind:
  * a 4-d or 2-d ``weight``: He-scaled normal, std sqrt(2 / fan_in);
  * a ``bias`` beside such a weight: zero;
  * a BatchNorm's ``scale``: U(0.8, 1.2); its ``bias`` and
    ``running_mean``: N(0, 0.05^2); ``running_var``: U(0.8, 1.2);
    ``num_batches_tracked``: 0 (the He-scaled classifier dicts of the
    port's tests, so that activations keep their scale through the
    torso).
A rule gives ``{"he": gain}`` (std sqrt(gain / fan_in)), ``{"normal":
std}``, ``{"uniform": [lo, hi]}`` or ``{"const": value}``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _rule(name: str, t: torch.Tensor, names, rules) -> dict:
    for r in rules:
        if r["match"] in name:
            return r
    leaf = name.rpartition(".")[2]
    if leaf == "weight" and t.ndim in (2, 4):
        return {"he": 2.0}
    if leaf == "bias" and name[:-4] + "weight" in names:
        return {"const": 0.0}
    if leaf == "scale" or leaf == "running_var":
        return {"uniform": [0.8, 1.2]}
    if leaf in ("bias", "running_mean"):
        return {"normal": 0.05}
    return {"const": 0.0}


def make(shapes: Dict[str, torch.Size], init: dict, seed: int,
         device) -> Dict[str, torch.Tensor]:
    """float32 tensors named and shaped as ``shapes``, from ``seed``."""
    names = set(shapes)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = torch.empty(shape, device=device)
        rule = _rule(name, t, names, init.get("rules", ()))
        if "he" in rule or "normal" in rule:
            fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
            std = (math.sqrt(rule["he"] / fan_in) if "he" in rule
                   else rule["normal"])
            t = (normal[at:at + n] * std).view(shape)
        elif "uniform" in rule:
            lo, hi = rule["uniform"]
            t = (lo + (hi - lo) * uniform[at:at + n]).view(shape)
        else:
            t.fill_(rule["const"])
        out[name] = t
        at += n
    return out
