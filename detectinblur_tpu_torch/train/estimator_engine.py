"""Image corruptions of the blur pipeline: noise, block and JPEG.

Port of ``apply_corruptions`` (``detectinblur_tpu/train/estimator_engine.py``
:34-74), the corruption chain the reference's manual_blur runs on each
blurred image (blur_functions.py:72-88). Every draw is per image: the
noise variance U(1e-8, noise_level) and the noise; the block decision
(U > 0.5) and scale U(0.6, 1); the JPEG decision (U > 0.35) and quality
U(20, 90).

The draws come from a ``torch.Generator``, or from a ``CorruptionDraws``
given by the caller (the tests feed the values JAX draws from its keys).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from detectinblur_tpu_torch.ops.jpeg import jpeg_compress_decompress


class CorruptionDraws(NamedTuple):
    """One row per image; the fields of a corruption that is off are not
    read and may be None."""
    noise_var: Optional[torch.Tensor] = None   # [B], U(1e-8, noise_level)
    noise: Optional[torch.Tensor] = None       # [B, H, W, 3], N(0, 1)
    block_u: Optional[torch.Tensor] = None     # [B], U(0, 1): block if > 0.5
    block_scale: Optional[torch.Tensor] = None  # [B], U(0.6, 1)
    jpeg_u: Optional[torch.Tensor] = None      # [B], U(0, 1): JPEG if > 0.35
    jpeg_quality: Optional[torch.Tensor] = None  # [B], U(20, 90)


def draw_corruptions(images: torch.Tensor, add_noise: bool,
                     noise_level: float, add_block: bool, add_jpeg: bool,
                     generator: Optional[torch.Generator] = None
                     ) -> CorruptionDraws:
    """The draws of the corruptions that are on, from ``generator`` (on
    the images' device)."""
    B = images.shape[0]
    dev = images.device

    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(B, generator=generator, device=dev)

    d = {}
    if add_noise:
        d["noise_var"] = u(1e-8, noise_level)
        d["noise"] = torch.randn(images.shape, generator=generator,
                                 device=dev)
    if add_block:
        d["block_u"], d["block_scale"] = u(), u(0.6, 1.0)
    if add_jpeg:
        d["jpeg_u"], d["jpeg_quality"] = u(), u(20.0, 90.0)
    return CorruptionDraws(**d)


def apply_corruptions(images: torch.Tensor, add_noise: bool = False,
                      noise_level: float = 0.001, add_block: bool = False,
                      add_jpeg: bool = False,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[CorruptionDraws] = None
                      ) -> torch.Tensor:
    """images [B, H, W, 3] float 0..1 (H and W multiples of 16 for JPEG)
    -> the corrupted images: noise, then block, then JPEG, each as asked.
    Draws come from ``draws`` or, when that is None, from ``generator``."""
    if not (add_noise or add_block or add_jpeg):
        return images
    if draws is None:
        draws = draw_corruptions(images, add_noise, noise_level, add_block,
                                 add_jpeg, generator)
    dev = images.device
    B, H, W, _ = images.shape
    img = images
    if add_noise:
        std = torch.sqrt(draws.noise_var.to(dev))[:, None, None, None]
        img = (img + draws.noise.to(dev) * std).clamp(0.0, 1.0)
    if add_block:
        # Nearest down- and up-sampling by the scale, as an index gather:
        # floor(i / s) * s in float32, truncated to an index.
        s = draws.block_scale.to(dev, torch.float32)[:, None]

        def index(n):
            i = torch.arange(n, dtype=torch.float32, device=dev)[None]
            return (torch.floor(i / s) * s).clamp(0, n - 1).long()

        b = torch.arange(B, device=dev)[:, None, None]
        blocked = img[b, index(H)[:, :, None], index(W)[:, None, :]]
        img = torch.where((draws.block_u.to(dev) > 0.5)[:, None, None, None],
                          blocked, img)
    if add_jpeg:
        compressed = jpeg_compress_decompress(img, draws.jpeg_quality.to(dev))
        img = torch.where((draws.jpeg_u.to(dev) > 0.35)[:, None, None, None],
                          compressed, img)
    return img
