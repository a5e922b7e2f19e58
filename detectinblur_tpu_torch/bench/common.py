"""What the three benchmark entry points share: the window timer, the
lower median, the JSON line, the card's name and its peak rate.

A window is timed as the JAX scripts time theirs: wall clock from a
``torch.cuda.synchronize()`` to a ``torch.cuda.synchronize()`` after its
last call, the counterpart of ``jax.block_until_ready``. On a card the
window's CUDA-event time comes beside it, for the scripts' stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Callable, Optional, Sequence

import torch

from detectinblur_tpu_torch.models.faster_rcnn import FasterRCNNConfig

# Dense bfloat16 tensor-core peak of one card, by the name that
# ``torch.cuda.get_device_name`` gives (the rate "MFU" is quoted against;
# ``bench_pipeline.py:44`` keeps the TPU rates). NVIDIA H100 Tensor Core
# GPU datasheet: SXM5 989.4 TFLOP/s, PCIe 756 TFLOP/s, dense (half the
# sparse figures). "cpu" is the JAX script's nominal 1e12.
PEAK_BF16_FLOPS = {
    "H100 80GB HBM3": 989.4e12,
    "H100 PCIe": 756e12,
    "cpu": 1e12,
}


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    """``--device`` and the shape flags every entry point takes; the
    defaults are the JAX scripts' protocol."""
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--height", type=int, default=480,
                        help="source image height")
    parser.add_argument("--width", type=int, default=640,
                        help="source image width")
    parser.add_argument("--min-size", type=int, default=800,
                        help="the model's resize (and bucket) min side")
    parser.add_argument("--max-size", type=int, default=1333)


def default_config(min_size: int = 800,
                   max_size: int = 1333) -> FasterRCNNConfig:
    """The JAX scripts' model: ResNet50-FPN with 91 classes, resizing to
    ``min_size`` / ``max_size``, in ``DETECTINBLUR_PRECISION`` if set,
    else throughput (``default``) precision."""
    return FasterRCNNConfig(
        min_size=min_size, max_size=max_size,
        precision=os.environ.get("DETECTINBLUR_PRECISION", "default"))


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lower_median(values: Sequence[float]) -> float:
    """The element at ``(n - 1) // 2`` of the sorted values
    (``bench.py:155``): with an even count the lower of the middle two."""
    return sorted(values)[(len(values) - 1) // 2]


def time_window(fn: Callable[[], object], device: torch.device):
    """(fn's result, wall seconds from a synchronize before ``fn`` to one
    after it, the CUDA-event ms of the same span or None off a card)."""
    cuda = device.type == "cuda"
    synchronize(device)
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        end.record()
    synchronize(device)
    wall = time.perf_counter() - t0
    return out, wall, start.elapsed_time(end) if cuda else None


def device_kind(device: torch.device) -> str:
    """The card's name, or "cpu" (JAX's ``device_kind`` on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def peak_bf16_flops(kind: str) -> Optional[float]:
    """The dense bfloat16 peak of the device named ``kind``, or None (and a
    line on stderr) for a card not in ``PEAK_BF16_FLOPS``: no guess."""
    for name, peak in PEAK_BF16_FLOPS.items():
        if name.lower() in kind.lower():
            return peak
    log(f"no bfloat16 peak known for {kind!r}: mfu is null")
    return None


def run_main(run: Callable[..., dict], parser: argparse.ArgumentParser,
             argv, kwargs: Callable[[argparse.Namespace], dict]) -> dict:
    """Parse ``argv``, call ``run(**kwargs(args))`` with whatever it
    prints sent to stderr, then print its record as one JSON line, the
    last line of stdout."""
    args = parser.parse_args(argv)
    with contextlib.redirect_stdout(sys.stderr):
        record = run(**kwargs(args))
    print(json.dumps(record), flush=True)
    return record

