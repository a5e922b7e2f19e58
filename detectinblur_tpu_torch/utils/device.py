"""Device and precision helpers.

Precision mirrors ``detectinblur_tpu/models/resnet.py:40-56``:

  * ``highest`` (the default): float32 everywhere, with TF32 switched off
    for both cuBLAS matmuls and cuDNN convolutions. cuDNN convolutions run
    in TF32 by default on Hopper, which keeps ~3 decimal digits, so parity
    mode has to turn it off explicitly.
  * ``default`` (throughput mode): bfloat16 activations in the backbone
    and heads; the RPN outputs and the box predictor outputs are float32
    (``rpn.py:50-53``, ``roi_heads.py:71-72``).

The process-wide default is read once, here, from
``DETECTINBLUR_PRECISION``; the model takes precision as an explicit
config field.
"""

from __future__ import annotations

import os

import torch

from detectinblur_tpu_torch.parallel.dist import (
    distributed,
    local_rank,
    rank_device,
)

PRECISIONS = ("default", "highest")
DEFAULT_PRECISION = os.environ.get("DETECTINBLUR_PRECISION", "highest")


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    return precision


def act_dtype(precision: str) -> torch.dtype:
    """Activation dtype of the backbone and heads for ``precision``."""
    return (torch.bfloat16 if check_precision(precision) == "default"
            else torch.float32)


def set_fp32_math() -> None:
    """Float32 matmuls and convolutions in full float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one. Raises when CUDA is wanted and absent, rather than
    quietly running on the CPU. Under a process group plain ``cuda`` is
    the process's own card, ``cuda:LOCAL_RANK`` (``parallel/dist.py``),
    which becomes the current device; an explicit ``cuda:K`` is kept."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    if distributed():
        dev = rank_device(dev, local_rank())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    return dev
