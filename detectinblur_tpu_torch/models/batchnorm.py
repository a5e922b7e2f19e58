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
- m^2. Under a process group, ``train`` mode in training takes them over
every process's batch (the global batch, as JAX's mean over a sharded
batch); the eval modes stay per process. ``train`` and ``acclimation``
update the running statistics with momentum 0.1 and the unbiased
variance, and count the batch, but write the update only while the
module is in training mode (the detector's ``loss``): JAX threads the
new statistics out of ``loss`` and drops them in ``predict``.

The affine (``scale``, ``bias``) is a pair of float32 parameters, as in
JAX: the detector's freeze mask (``train/state.py``) keeps them fixed,
the blur estimator trains them. ``running_mean``, ``running_var`` and
``num_batches_tracked`` are float32 buffers. As in JAX, the output is
computed in float32 from the statistics and the affine, so bfloat16
activations come out float32 (the next convolution casts them back).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from detectinblur_tpu_torch.parallel.dist import all_reduce_sum, distributed
from detectinblur_tpu_torch.utils.profiling import span

MODES = ("train", "eval", "acclimation", "mode_one")


class AdaptiveBatchNorm(nn.Module):
    def __init__(self, features: int, mode: str = "train", eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode, self.eps, self.momentum = mode, eps, momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros(()))

    def extra_repr(self) -> str:
        return f"{self.scale.shape[0]}, mode={self.mode}"

    @staticmethod
    def _global_moments(x32: torch.Tensor, n: int):
        """(mean, biased variance, count) over every process's batch: the
        sums of x and x^2 and the count, all-reduced in float64 with the
        differentiable sum, as JAX's mean over the batch axes of a sharded
        batch. The count stays a tensor on the device, so no layer waits
        on the host."""
        C = x32.shape[1]
        sums = torch.cat([x32.sum(dim=(0, 2, 3)),
                          x32.square().sum(dim=(0, 2, 3)),
                          x32.new_full((1,), float(n))]).double()
        sums = all_reduce_sum(sums)
        total = sums[2 * C]
        m = (sums[:C] / total).float()
        v = (sums[C:2 * C] / total).float() - m.square()
        return m, v, total.float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("norm"):
            return self._normalize(x)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        mode = self.mode
        if mode == "eval":
            use_m, use_v = self.running_mean, self.running_var
        else:
            x32 = x.float()
            n = x32.numel() // x32.shape[1]
            if mode == "train" and self.training and distributed():
                m, v, n = self._global_moments(x32, n)
            else:
                m = x32.mean(dim=(0, 2, 3))
                v = x32.square().mean(dim=(0, 2, 3)) - m.square()   # biased
            use_m, use_v = m, v
            if mode in ("train", "acclimation"):
                unbiased = (v * n / max(n - 1, 1) if isinstance(n, int)
                            else v * n / (n - 1).clamp(min=1))
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
        # Float32 statistics and affine promote the activations, as in JAX.
        return ((x - use_m.view(shape)) * inv.view(shape)
                * self.scale.view(shape) + self.bias.view(shape))


def set_num_batches_tracked(module: nn.Module, value: float) -> None:
    """Set ``num_batches_tracked`` of every ``AdaptiveBatchNorm`` in
    ``module`` to ``value`` (``cli.evaluate`` sets 16 for ``mode_one``)."""
    for m in module.modules():
        if isinstance(m, AdaptiveBatchNorm):
            m.num_batches_tracked.fill_(value)


@contextlib.contextmanager
def bn_mode(module: nn.Module, mode: str):
    """Every ``AdaptiveBatchNorm`` of ``module`` in ``mode`` while open
    (the blur estimator's eval step: JAX clones it with ``bn_mode="eval"``)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    norms = [m for m in module.modules() if isinstance(m, AdaptiveBatchNorm)]
    saved = [m.mode for m in norms]
    for m in norms:
        m.mode = mode
    try:
        yield module
    finally:
        for m, old in zip(norms, saved):
            m.mode = old


@contextlib.contextmanager
def training_mode(module: nn.Module):
    """``module`` in training mode while open: its BatchNorms of the
    ``train`` and ``acclimation`` modes write their running-statistics
    updates."""
    was = module.training
    module.train(True)
    try:
        yield module
    finally:
        module.train(was)
