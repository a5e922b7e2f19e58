"""Checkpoints: save, resume, start from weights.

Port of ``detectinblur_tpu/train/checkpoint.py`` on ``torch.save``. The
reference's scheme (train.py:332-339): per-epoch ``model_{epoch}.pt``
holding ``{model, optimizer, step, epoch}`` plus ``args_{epoch}.json``,
written by process 0 only (the model itself, never its DDP wrapper, so
the keys are the same at any process count), after which every process
waits for the file; ``--resume`` restores all of it, onto each process's
own device, ``--start_from_weights`` the weights only, from a full
checkpoint or a bare state dict. The model's state dict carries its BatchNorm running
statistics (a MobileNetV2 torso's, or a ``bn_mode`` backbone's), so they
come back bit for bit with the weights; JAX keeps them in a ``bn_stats``
subtree beside them (:32).

Loading is strict. A missing or unexpected key, a wrong shape, a
momentum buffer that does not fit its parameter, or a file without the
part asked of it raises: nothing falls back to the caller's fresh
weights or optimizer (the JAX package's Orbax restore once did, silently;
fb3edaf). Files are read with ``weights_only=True``.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional

import torch
from torch import nn

from detectinblur_tpu_torch.parallel.dist import barrier, is_main_process
from detectinblur_tpu_torch.train.state import TrainState

FULL_KEYS = frozenset({"model", "optimizer", "step", "epoch"})
# The running-statistics buffers of an AdaptiveBatchNorm.
BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


def save_checkpoint(output_dir: str, state: TrainState, epoch: int,
                    args: Optional[dict] = None) -> str:
    path = os.path.join(os.path.abspath(output_dir), f"model_{epoch}.pt")
    if is_main_process():
        os.makedirs(output_dir, exist_ok=True)
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step, "epoch": epoch}, path)
        if args is not None:
            with open(os.path.join(output_dir, f"args_{epoch}.json"), "w") as f:
                json.dump(args, f, indent=2, default=str)
    barrier()
    return path


def _load(path: str) -> dict:
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: not a checkpoint or a state dict")
    return obj


def _is_full(obj: Mapping) -> bool:
    return set(obj) == FULL_KEYS


def _check_state_dict(sd: Mapping[str, torch.Tensor],
                     model: nn.Module) -> None:
    """Raise ``KeyError`` unless ``sd`` has exactly the model's keys, and
    ``ValueError`` on a value that is not a tensor or a shape that
    differs."""
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing={missing[:5]} "
                       f"extra={extra[:5]}")
    odd = sorted(k for k, v in sd.items() if not isinstance(v, torch.Tensor))
    if odd:
        raise ValueError(f"not tensors: {odd[:5]}")
    bad = [(k, tuple(sd[k].shape), tuple(want[k].shape)) for k in sd
           if tuple(sd[k].shape) != tuple(want[k].shape)]
    if bad:
        raise ValueError(f"shape mismatches: {bad[:5]}")


def _load_weights(model: nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    _check_state_dict(sd, model)
    model.load_state_dict(sd, strict=True)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a full checkpoint into ``state``'s model and optimizer; the
    returned state carries the checkpoint's step."""
    obj = _load(path)
    if not _is_full(obj):
        raise KeyError(f"{path}: not a full checkpoint (keys "
                       f"{sorted(obj)[:5]}, want {sorted(FULL_KEYS)})")
    _load_weights(state.model, obj["model"])
    opt_sd = obj["optimizer"]
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    ids = [i for g in opt_sd["param_groups"] for i in g["params"]]
    if len(ids) != len(params):
        raise ValueError(f"{path}: the optimizer holds {len(ids)} "
                         f"parameters, this one {len(params)}")
    for i, p in zip(ids, params):
        buf = opt_sd["state"].get(i, {}).get("momentum_buffer")
        if buf is not None and buf.shape != p.shape:
            raise ValueError(f"{path}: momentum buffer {i} has shape "
                             f"{tuple(buf.shape)}, its parameter "
                             f"{tuple(p.shape)}")
    state.optimizer.load_state_dict(opt_sd)
    return TrainState(int(obj["step"]), state.model, state.optimizer)


def restore_weights(path: str, model: nn.Module,
                    fresh_bn_stats: bool = False) -> nn.Module:
    """--start_from_weights: load the weights of a full checkpoint (its
    optimizer and step are left alone) or of a bare state dict into
    ``model``. With ``fresh_bn_stats``, a file that holds no BatchNorm
    running statistics at all (one written by a FrozenBatchNorm model)
    leaves ``model``'s own in place, as the JAX package's
    ``restore_subtree`` falls back to its template; a file that holds
    some of them must hold them all."""
    obj = _load(path)
    sd = obj["model"] if _is_full(obj) else obj
    if fresh_bn_stats and not any(k.rpartition(".")[2] in BN_STATS
                                  for k in sd):
        print(f"{path} holds no BatchNorm statistics; using the fresh ones")
        sd = dict(sd, **{k: v for k, v in model.state_dict().items()
                         if k.rpartition(".")[2] in BN_STATS})
    _load_weights(model, sd)
    return model


def latest_epoch(output_dir: str) -> Optional[int]:
    """The newest ``model_{epoch}.pt`` in ``output_dir``, or None."""
    if not os.path.isdir(output_dir):
        return None
    epochs = []
    for name in os.listdir(output_dir):
        stem, ext = os.path.splitext(name)
        if name.startswith("model_") and ext == ".pt":
            try:
                epochs.append(int(stem.split("_", 1)[1]))
            except ValueError:
                pass
    return max(epochs) if epochs else None
