"""DeepDeblur's MSResNet, the deblurrer of ``--deblur_first``.

Port of ``detectinblur_tpu/models/deblur.py``: ``ResBlock`` (:31),
``ScaleResNet`` (:43), ``MSResNet`` (:67, torch's PixelShuffle standing
for JAX's ``pixel_shuffle`` :58), ``gaussian_pyramid`` (:94) and
``deblur_image`` (:137). Three scales run
coarse to fine; each is a plain convolutional ResNet (a 5x5 head conv,
``n_blocks`` ResBlocks of conv-relu-conv with a skip, a 5x5 tail conv),
and each finer scale takes its pyramid level concatenated with the
PixelShuffle of an up-conv of the coarser scale's output (6 channels).
Values are shifted by 127.5 (``rgb_range`` 255 / 2).

Module names mirror the JAX tree (``scale0.head``, ``scale0.block3.conv1``,
``up1``); ``utils/convert.deepdeblur_from_torch`` maps a DeepDeblur
checkpoint onto them. The activations are NCHW channels-last.

JAX runs the deblurrer at ``HIGHEST`` whatever ``DETECTINBLUR_PRECISION``
says, so here it is float32 with TF32 off in both precision modes.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from detectinblur_tpu_torch.utils.device import set_fp32_math

RGB_RANGE = 255.0


def _conv(cin: int, cout: int, kernel: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, padding=kernel // 2)


class ResBlock(nn.Module):
    def __init__(self, feats: int = 64, kernel: int = 5):
        super().__init__()
        self.conv0 = _conv(feats, feats, kernel)
        self.conv1 = _conv(feats, feats, kernel)

    def forward(self, x):
        return x + self.conv1(F.relu(self.conv0(x)))


class ScaleResNet(nn.Module):
    def __init__(self, in_ch: int = 3, out_ch: int = 3, feats: int = 64,
                 kernel: int = 5, n_blocks: int = 19):
        super().__init__()
        self.n_blocks = n_blocks
        self.head = _conv(in_ch, feats, kernel)
        for i in range(n_blocks):
            self.add_module(f"block{i}", ResBlock(feats, kernel))
        self.tail = _conv(feats, out_ch, kernel)

    def forward(self, x):
        x = self.head(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        return self.tail(x)


class MSResNet(nn.Module):
    """pyramid (finest first, each [B, 3, H/2^s, W/2^s] in 0..255) -> the
    output pyramid, same shapes."""

    def __init__(self, n_scales: int = 3, feats: int = 64, kernel: int = 5,
                 n_blocks: int = 19):
        super().__init__()
        self.n_scales = n_scales
        for s in range(n_scales):
            in_ch = 3 if s == n_scales - 1 else 6
            self.add_module(f"scale{s}", ScaleResNet(in_ch, 3, feats, kernel,
                                                     n_blocks))
            if s > 0:
                self.add_module(f"up{s}", _conv(3, 12, kernel))

    @classmethod
    def from_state_dict(cls, sd) -> "MSResNet":
        """The MSResNet whose architecture matches the port's state dict
        ``sd`` (scale count, features, kernel and block count inferred, as
        JAX's ``msresnet_from_variables`` :123), with ``sd`` loaded."""
        n_scales = sum(1 for k in sd if k.startswith("scale")
                       and k.endswith(".head.weight"))
        head = sd["scale0.head.weight"]
        n_blocks = sum(1 for k in sd if k.startswith("scale0.block")
                       and k.endswith(".conv0.weight"))
        net = cls(n_scales, head.shape[0], head.shape[-1], n_blocks)
        net.load_state_dict(sd)
        return net

    def forward(self, pyramid: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        mean = RGB_RANGE / 2.0
        inputs = [p - mean for p in pyramid]
        outputs = [None] * self.n_scales
        x = inputs[-1]
        for s in range(self.n_scales - 1, -1, -1):
            outputs[s] = getattr(self, f"scale{s}")(x)
            if s > 0:
                # torch's PixelShuffle order is JAX's ``pixel_shuffle``.
                up = F.pixel_shuffle(getattr(self, f"up{s}")(outputs[s]), 2)
                x = torch.cat([inputs[s - 1], up], dim=1)
        return [o + mean for o in outputs]


def _gaussian_kernel():
    sigma = 2.0 * 2 / 6.0
    radius = int(4 * sigma + 0.5)
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32), radius


def _smooth(x: torch.Tensor, kern: Sequence[float], radius: int,
            dim: int) -> torch.Tensor:
    """The 1-D Gaussian along ``dim`` of [B, C, H, W], numpy's
    ``symmetric`` padding (the edge sample repeated), taps summed in
    order."""
    n = x.shape[dim]
    idx = torch.as_tensor(np.pad(np.arange(n), radius, mode="symmetric"),
                          device=x.device)
    padded = x.index_select(dim, idx)
    out = kern[0] * padded.narrow(dim, 0, n)
    for t in range(1, len(kern)):
        out = out + kern[t] * padded.narrow(dim, t, n)
    return out


def gaussian_pyramid(img: torch.Tensor, n_scales: int = 3
                     ) -> List[torch.Tensor]:
    """skimage's ``pyramid_gaussian``: smooth with sigma 2/3 (separable,
    symmetric padding), then keep every second row and column, repeated.
    img [B, C, H, W]; finest first."""
    k, radius = _gaussian_kernel()
    kern = [float(v) for v in k]
    pyr = [img]
    for _ in range(n_scales - 1):
        sm = _smooth(_smooth(pyr[-1], kern, radius, 2), kern, radius, 3)
        pyr.append(sm[:, :, ::2, ::2])
    return pyr


@torch.no_grad()
def deblur_image(net: MSResNet, images01: torch.Tensor) -> torch.Tensor:
    """DeepDeblur's deblurImage on a batch: images [B, H, W, 3] in 0..1 ->
    deblurred [B, H, W, 3] in 0..1. Each image is edge-padded to a
    multiple of 2^(n_scales - 1), run through the pyramid and the net,
    unpadded, and mapped back by clip(x + 0.5, 0, 255) / 255."""
    if images01.is_cuda:
        set_fp32_math()
    B, H, W, _ = images01.shape
    div = 2 ** (net.n_scales - 1)
    ph, pw = (-H) % div, (-W) % div
    x = (images01.float() * 255.0).permute(0, 3, 1, 2)
    x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    x = x.contiguous(memory_format=torch.channels_last)
    fine = net(gaussian_pyramid(x, net.n_scales))[0][:, :, :H, :W]
    return (torch.clamp(fine + 0.5, 0.0, 255.0) / 255.0).permute(0, 2, 3, 1)
