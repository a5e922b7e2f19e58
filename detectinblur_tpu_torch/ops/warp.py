"""The "Squint" affine warp of images and feature maps.

Port of ``detectinblur_tpu/ops/warp.py`` (``squint_matrix`` :21,
``squint_warp`` :84): per image, the 2x3 normalized-coordinate affine
built from the PSF's principal components (theta, lambda1, lambda2),
applied with ``F.affine_grid`` + ``F.grid_sample`` (bilinear, zero
padding, ``align_corners=False``), the pair the JAX version re-implements.
The detector warps its input with (theta, lambda1, lambda2) and each FPN
level back with (theta, 1/lambda1, 1/lambda2).

Tensors are NHWC at this boundary. The sampling runs in float32 whatever
the input's dtype (a bfloat16 grid would misplace samples by up to half a
pixel on a 272-wide level), and the result comes back as a contiguous
NHWC tensor in the input's dtype: the one copy the warp costs, and the
layout the RoIAlign kernel reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def squint_matrix(theta: torch.Tensor, lam1: torch.Tensor,
                  lam2: torch.Tensor) -> torch.Tensor:
    """The [B, 2, 3] affine of ``affine_grid`` in the closed form of the
    JAX version: R diag(1/lam1, 1/lam2) R^T with R the rotation by
    -theta, and no translation."""
    th = -theta.to(torch.float32)
    c, s = torch.cos(th), torch.sin(th)
    i1, i2 = 1.0 / lam1.to(torch.float32), 1.0 / lam2.to(torch.float32)
    a11 = c * c * i1 + s * s * i2
    a22 = s * s * i1 + c * c * i2
    a12 = c * s * (i2 - i1)
    zero = torch.zeros_like(a11)
    return torch.stack([torch.stack([a11, a12, zero], -1),
                        torch.stack([a12, a22, zero], -1)], -2)


def squint_warp(images: torch.Tensor, thetas: torch.Tensor,
                lam1s: torch.Tensor, lam2s: torch.Tensor) -> torch.Tensor:
    """Warp a batch [B, H, W, C] with per-image parameters [B] ->
    [B, H, W, C], contiguous, in the input's dtype."""
    B, H, W, C = images.shape
    x = images.permute(0, 3, 1, 2).float()
    m = squint_matrix(thetas, lam1s, lam2s).to(images.device)
    grid = F.affine_grid(m, [B, C, H, W], align_corners=False)
    out = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return images.new_empty(images.shape).copy_(out.permute(0, 2, 3, 1))
