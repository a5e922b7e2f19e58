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

Host values reach the card without making the host wait on it:
``device_constant`` keeps one copy of a constant table per (device,
dtype), and ``to_device_async`` copies a per-call host value from pinned
memory with ``non_blocking=True``. A pageable copy to the card blocks the
host until the stream drains, which JAX's asynchronous device puts never
do.
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


def _full_device(device) -> torch.device:
    """``device`` with its index: plain ``cuda`` is the current card, so
    that each process of a group keys its own (``parallel/dist.py``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device_async(value, device) -> torch.Tensor:
    """``value`` (a host array, a CPU tensor, or a tensor already on a
    card) as a tensor on ``device``, of the dtype ``torch.as_tensor``
    gives it. To a card, a host value goes from pinned memory with
    ``non_blocking=True``, so the host does not wait on the stream: a
    tensor the loader pinned as it is, anything else from a fresh pinned
    copy (never the caller's buffer, which the host may overwrite before
    the copy runs; PyTorch's caching host allocator keeps the pinned
    block until the copy is done). On the CPU nothing is pinned."""
    device = torch.device(device)
    if isinstance(value, torch.Tensor) and value.device.type != "cpu":
        return value.to(device, non_blocking=True)
    host = torch.as_tensor(value)
    if device.type != "cuda":
        return host.to(device)
    if not host.is_pinned():
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


_CONSTANTS = {}


def device_constant(values, device, dtype: torch.dtype) -> torch.Tensor:
    """The constant table ``values`` (nested tuples of numbers) as a
    ``dtype`` tensor on ``device``, made once per (values, device, dtype)
    with ``to_device_async`` and shared by every later call: callers
    must not write to it."""
    key = (values, _full_device(device), dtype)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = to_device_async(torch.tensor(values, dtype=dtype),
                                          key[1])
    return _CONSTANTS[key]
