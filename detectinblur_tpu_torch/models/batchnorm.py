"""BatchNorm with the reference's test-time adaptation modes.

Port of ``detectinblur_tpu/models/batchnorm.py`` (``AdaptiveBatchNorm``
:24, ``set_num_batches_tracked`` :82), over NCHW activations. The mode
alone decides how a batch is normalized:

  * ``train``: with the batch's statistics;
  * ``eval``: with the running statistics;
  * ``acclimation``: with the running statistics after the batch's update;
  * ``mode_one``: with the blend N/(N+1) running + 1/(N+1) batch, N being
    ``num_batches_tracked`` (``cli.evaluate`` sets 16 for a ``.pth``).

The batch statistics are taken over N, H and W of the whole padded canvas
in float32 whatever the activations' dtype, the variance biased as E[x^2]
- m^2. ``train`` and ``acclimation`` update the running statistics with
momentum 0.1 and the unbiased variance, and count the batch, but write
the update only while the module is in training mode (the detector's
``loss``): JAX threads the new statistics out of ``loss`` and drops them
in ``predict``.

The affine (``scale``, ``bias``) is a pair of buffers, as the port's
FrozenBatchNorm keeps it: the JAX freeze mask never trains a BatchNorm
affine of the backbone, whatever the mode. ``running_mean``,
``running_var`` and ``num_batches_tracked`` are float32 buffers.
"""

from __future__ import annotations

import torch
from torch import nn

MODES = ("train", "eval", "acclimation", "mode_one")


class AdaptiveBatchNorm(nn.Module):
    def __init__(self, features: int, mode: str = "train", eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode, self.eps, self.momentum = mode, eps, momentum
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros(()))

    def extra_repr(self) -> str:
        return f"{self.scale.shape[0]}, mode={self.mode}"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode = self.mode
        if mode == "eval":
            use_m, use_v = self.running_mean, self.running_var
        else:
            x32 = x.float()
            n = x32.numel() // x32.shape[1]
            m = x32.mean(dim=(0, 2, 3))
            v = x32.square().mean(dim=(0, 2, 3)) - m.square()   # biased
            use_m, use_v = m, v
            if mode in ("train", "acclimation"):
                unbiased = v * n / max(n - 1, 1)
                new_m = ((1 - self.momentum) * self.running_mean
                         + self.momentum * m)
                new_v = ((1 - self.momentum) * self.running_var
                         + self.momentum * unbiased)
                if self.training:
                    with torch.no_grad():
                        self.running_mean.copy_(new_m)
                        self.running_var.copy_(new_v)
                        self.num_batches_tracked.add_(1.0)
                if mode == "acclimation":
                    use_m, use_v = new_m, new_v
            elif mode == "mode_one":
                N = self.num_batches_tracked
                sf, bf = N / (N + 1.0), 1.0 / (N + 1.0)
                use_m = sf * self.running_mean + bf * m
                use_v = sf * self.running_var + bf * v
        inv = torch.rsqrt(use_v + self.eps)
        shape = (1, -1, 1, 1)
        return ((x - use_m.to(x.dtype).view(shape)) * inv.to(x.dtype).view(shape)
                * self.scale.to(x.dtype).view(shape)
                + self.bias.to(x.dtype).view(shape))


def set_num_batches_tracked(module: nn.Module, value: float) -> None:
    """Set ``num_batches_tracked`` of every ``AdaptiveBatchNorm`` in
    ``module`` to ``value`` (``cli.evaluate`` sets 16 for ``mode_one``)."""
    for m in module.modules():
        if isinstance(m, AdaptiveBatchNorm):
            m.num_batches_tracked.fill_(value)
