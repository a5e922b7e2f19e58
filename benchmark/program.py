"""The program under test, built from a configuration file: the port's
model class and its config types, named in the file's ``program``
section as ``module:attribute``. Each field of the port's config type is
filled from the field of the same name in the file (nested config types
from the file's group of that name, with ``num_classes``), or from
``program.fields``; the port's defaults hold for the rest.

The weights are the benchmark's (``weights.py``), made from the reference
detector's state dict, and loaded strictly: a tensor the port names or
shapes otherwise stops the run.
"""

from __future__ import annotations

import importlib

import torch

from benchmark import weights
from benchmark.reference.models import Detector


def _load(path: str):
    module, _, attr = path.partition(":")
    return getattr(importlib.import_module(module), attr)


def port_config(cfg: dict):
    prog = cfg["program"]
    cls = _load(prog["config"])
    kwargs = {}
    for field in cls._fields:
        if field in prog["nested"]:
            sub = _load(prog["nested"][field])
            src = dict(cfg[field], num_classes=cfg["num_classes"])
            kwargs[field] = sub(**{k: v for k, v in src.items()
                                   if k in sub._fields})
        elif field in prog["fields"]:
            kwargs[field] = prog["fields"][field]
        elif field in cfg and not isinstance(cfg[field], (dict, list)):
            kwargs[field] = cfg[field]
    return cls(**kwargs)


def reference_shapes(cfg: dict):
    """Names and shapes of the reference detector's state dict."""
    with torch.device("meta"):
        model = Detector(cfg)
    return {k: v.shape for k, v in model.state_dict().items()}


def start_weights(cfg: dict, seed: int, device, mix: dict = None):
    """The cell's start weights: the traffic mix's ``init`` rules first
    (a training job's fresh heads), then the configuration's."""
    rules = ((mix or {}).get("init", {}).get("rules", [])
             + cfg.get("init", {}).get("rules", []))
    return weights.make(reference_shapes(cfg), {"rules": rules}, seed,
                        device)


def port_model(cfg: dict, state: dict, device):
    """The port's detector for ``cfg`` on ``device``, holding ``state``."""
    model = _load(cfg["program"]["model"])(port_config(cfg), device=device)
    model.load_state_dict(state, strict=True)
    return model


def reference_model(cfg: dict, state: dict, device,
                    dtype: torch.dtype = torch.float32) -> Detector:
    """The reference detector holding ``state``, in ``dtype`` (float32 or
    float64), TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        model = Detector(cfg)
    model = model.to_empty(device=device).to(dtype)
    model.load_state_dict(state, strict=True)
    return model.eval()
