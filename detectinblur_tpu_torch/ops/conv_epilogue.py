"""The pass after a convolution whose frozen BatchNorm scale was folded
into its weight: ``out = relu(y + shift [+ residual])`` over
channels-last NCHW tensors, summed in float32 and rounded once to ``y``'s
dtype (``models/resnet.py`` calls it after each folded
convolution; the JAX package leaves the same sums to XLA).

For CUDA tensors ``conv_epilogue`` launches the kernel of
``csrc/conv_epilogue.cu`` (``conv_epilogue_kernel``), through an autograd
Function when a gradient is needed: its backward is ``grad * (out > 0)``
from the saved output (``threshold_backward``), the same gradient for
``y`` and the residual, none for the shift. For CPU tensors it runs the
plain torch version ``conv_epilogue_plain``, which autograd
differentiates. ``conv_epilogue_kernel.launches`` counts kernel calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from detectinblur_tpu_torch.utils import cuda_build
from detectinblur_tpu_torch.utils.profiling import counts_launches

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHANNEL_MULTIPLE = 8   # channels a 16-byte bf16 vector holds


@functools.lru_cache(maxsize=None)
def _kernel():
    """``conv_epilogue(dtype, y, shift, residual, out, numel, channels,
    stream) -> CUDA error`` of ``csrc/conv_epilogue.cu``."""
    fn = cuda_build.load("conv_epilogue").conv_epilogue
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def conv_epilogue_plain(y: torch.Tensor, shift: torch.Tensor,
                        residual: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The kernel's arithmetic in torch: ``(y + shift) + residual`` in
    float32, ReLU'd, then rounded once to ``y``'s dtype."""
    out = y.float() + shift.float().view(1, -1, 1, 1)
    if residual is not None:
        out = out + residual.float()
    return torch.relu(out).to(y.dtype)


def _check(y: torch.Tensor, shift: torch.Tensor,
           residual: Optional[torch.Tensor]) -> None:
    cl = torch.channels_last
    if y.dtype not in _DTYPES:
        raise TypeError(f"y must be float32 or bfloat16, got {y.dtype}")
    if y.dim() != 4 or y.shape[1] % CHANNEL_MULTIPLE:
        raise ValueError(f"y must be NCHW with channels a multiple of "
                         f"{CHANNEL_MULTIPLE}, got {tuple(y.shape)}")
    if not y.is_contiguous(memory_format=cl) or y.data_ptr() % 16:
        raise ValueError("y must be channels-last contiguous and 16-byte "
                         "aligned")
    dev = y.get_device()
    if residual is not None and (
            residual.dtype != y.dtype or residual.shape != y.shape
            or residual.get_device() != dev
            or not residual.is_contiguous(memory_format=cl)
            or residual.data_ptr() % 16):
        raise ValueError("the residual must match y's device, dtype, shape "
                         "and layout, 16-byte aligned")
    if (shift.dtype != torch.float32 or shift.dim() != 1
            or shift.shape[0] != y.shape[1] or shift.get_device() != dev
            or not shift.is_contiguous() or shift.data_ptr() % 16):
        raise ValueError(f"shift must be a contiguous, 16-byte aligned "
                         f"float32 [{y.shape[1]}] on y's device")


@counts_launches
def conv_epilogue_kernel(y: torch.Tensor, shift: torch.Tensor,
                         residual: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The kernel alone, on the current stream: ``y`` and ``residual``
    channels-last float32 or bfloat16 CUDA tensors, ``shift`` float32
    [C]. Raises on anything else."""
    _check(y, shift, residual)
    out = torch.empty_like(y, memory_format=torch.channels_last)
    dev = y.get_device()
    args = (_DTYPES[y.dtype], y.data_ptr(), shift.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), y.numel(), y.shape[1])
    if dev == torch.cuda.current_device():
        err = _kernel()(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = _kernel()(*args, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f"conv_epilogue kernel launch failed: CUDA error "
                           f"{err}")
    conv_epilogue_kernel.launches += 1
    return out


class _Epilogue(torch.autograd.Function):
    """The kernel, differentiable in ``y`` and ``residual``."""

    @staticmethod
    def forward(ctx, y, shift, residual):
        out = conv_epilogue_kernel(y, shift, residual)
        ctx.has_residual = residual is not None
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        grad = torch.ops.aten.threshold_backward(grad, out, 0)
        return grad, None, grad if ctx.has_residual else None


def conv_epilogue(y: torch.Tensor, shift: torch.Tensor,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu(y + shift [+ residual])`` for NCHW ``y`` [N, C, H, W] (and
    ``residual`` of its shape) and float32 ``shift`` [C], in ``y``'s dtype:
    the kernel for CUDA tensors (channels-last; other layouts are copied
    to it), the plain version for CPU tensors."""
    if not y.is_cuda:
        if y.device.type != "cpu":
            raise ValueError(f"unsupported device {y.device}")
        return conv_epilogue_plain(y, shift, residual)
    y = y.contiguous(memory_format=torch.channels_last)
    if residual is not None:
        residual = residual.contiguous(memory_format=torch.channels_last)
    if torch.is_grad_enabled() and (
            y.requires_grad
            or (residual is not None and residual.requires_grad)):
        return _Epilogue.apply(y, shift, residual)
    return conv_epilogue_kernel(y, shift, residual)
