"""Differentiable JPEG compression (``--add_jpeg_artefacts``).

Port of ``detectinblur_tpu/ops/jpeg.py``, batched: RGB -> YCbCr (the JPEG
matrix, in the x255 domain), 2x2 average-pool chroma subsampling, 8x8
block DCT-II, quantization by the standard luma and chroma tables scaled
by ``quality_to_factor``, the differentiable rounding round(x) + (x -
round(x))^3, then the inverse path with nearest chroma upsampling and a
0..255 clamp.

The DCT is one [64, 64] matrix product over the blocks, where the JAX
version contracts an 8x8x8x8 tensor: the same products, summed in another
order. The rounding jumps by 0.75 of a quantization step where x - round(x)
crosses +-0.5, so a coefficient that float32 noise moves across such a tie
rounds the other way; ``tests/test_torch_port_remedies.py`` says how the
comparison with JAX treats those.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

Y_TABLE = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61],
     [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56],
     [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77],
     [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)

C_TABLE = np.full((8, 8), 99, np.float32)
C_TABLE[:4, :4] = np.array(
    [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]],
    np.float32)

_RGB2YCBCR = np.array(
    [[0.299, 0.587, 0.114],
     [-0.168736, -0.331264, 0.5],
     [0.5, -0.418688, -0.081312]], np.float32).T
_YCBCR_SHIFT = np.array([0.0, 128.0, 128.0], np.float32)
_YCBCR2RGB = np.array(
    [[1.0, 0.0, 1.402],
     [1.0, -0.344136, -0.714136],
     [1.0, 1.772, 0.0]], np.float32).T


def _dct_tensor():
    t = np.zeros((8, 8, 8, 8), np.float32)
    for x, y, u, v in itertools.product(range(8), repeat=4):
        t[x, y, u, v] = np.cos((2 * x + 1) * u * np.pi / 16) * np.cos(
            (2 * y + 1) * v * np.pi / 16)
    alpha = np.array([1.0 / np.sqrt(2)] + [1.0] * 7, np.float32)
    scale = np.outer(alpha, alpha) * 0.25
    return t.reshape(64, 64), scale


_DCT_T, _DCT_SCALE = _dct_tensor()


def diff_round(x: torch.Tensor) -> torch.Tensor:
    r = torch.round(x)
    return r + (x - r) ** 3


def quality_to_factor(quality) -> torch.Tensor:
    quality = torch.as_tensor(quality, dtype=torch.float32)
    q = torch.where(quality < 50, 5000.0 / quality,
                    (200.0 - quality * 2) + 0.01)
    return q / 100.0


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, H/8 * W/8, 64]."""
    B, H, W = x.shape
    return (x.reshape(B, H // 8, 8, W // 8, 8).permute(0, 1, 3, 2, 4)
             .reshape(B, -1, 64))


def _unblocks(b: torch.Tensor, H: int, W: int) -> torch.Tensor:
    B = b.shape[0]
    return (b.reshape(B, H // 8, W // 8, 8, 8).permute(0, 1, 3, 2, 4)
             .reshape(B, H, W))


def jpeg_dct(c: torch.Tensor) -> torch.Tensor:
    """The scaled DCT-II coefficients [B, n_blocks, 64] of channel planes
    [B, H, W] (x255 domain, H and W multiples of 8)."""
    t = torch.from_numpy(_DCT_T).to(c.device)
    scale = torch.from_numpy(_DCT_SCALE).to(c.device).reshape(64)
    return (_blocks(c) - 128.0) @ t * scale


def _idct(b: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(_DCT_T).to(b.device)
    scale = torch.from_numpy(_DCT_SCALE).to(b.device).reshape(64)
    return (b * scale) @ t.T + 128.0


def jpeg_planes(image: torch.Tensor):
    """(Y [B, H, W], Cb and Cr subsampled [B, H/2, W/2]) of images
    [B, H, W, 3] 0..1, in the x255 domain."""
    B, H, W, _ = image.shape
    ycbcr = (image * 255.0 @ torch.from_numpy(_RGB2YCBCR).to(image.device)
             + torch.from_numpy(_YCBCR_SHIFT).to(image.device))

    def sub(c):   # 2x2 average pooling
        return c.reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4))

    return ycbcr[..., 0], sub(ycbcr[..., 1]), sub(ycbcr[..., 2])


def jpeg_compress_decompress(image: torch.Tensor, quality,
                             differentiable: bool = True) -> torch.Tensor:
    """image [B, H, W, 3] float 0..1 with H and W multiples of 16, quality
    a number or [B] -> the decompressed images, same shape."""
    rounding = diff_round if differentiable else torch.round
    B, H, W, _ = image.shape
    factor = quality_to_factor(quality).to(image.device).reshape(-1, 1, 1)
    comps = []
    for c, table, full in zip(jpeg_planes(image), (Y_TABLE, C_TABLE, C_TABLE),
                              (True, False, False)):
        t = torch.from_numpy(table).to(image.device).reshape(1, 1, 64) * factor
        q = rounding(jpeg_dct(c) / t)
        h, w = (H, W) if full else (H // 2, W // 2)
        rec = _unblocks(_idct(q * t), h, w)
        if not full:
            rec = rec.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        comps.append(rec)
    ycbcr = (torch.stack(comps, dim=-1)
             - torch.from_numpy(_YCBCR_SHIFT).to(image.device))
    rgb = ycbcr @ torch.from_numpy(_YCBCR2RGB).to(image.device)
    return rgb.clamp(0.0, 255.0) / 255.0


def add_jpeg_artifact(image: torch.Tensor, quality) -> torch.Tensor:
    """One image [H, W, 3] 0..1: reflect-pad to a multiple of 16 (a whole
    16 on a side that already is one, as the reference pads), compress,
    crop back."""
    H, W = image.shape[:2]
    ph, pw = 16 - H % 16, 16 - W % 16
    top, left = ph // 2, pw // 2
    padded = F.pad(image.permute(2, 0, 1)[None],
                   (left, pw - left, top, ph - top), mode="reflect")
    out = jpeg_compress_decompress(padded[0].permute(1, 2, 0)[None], quality)
    return out[0, top:top + H, left:left + W]
