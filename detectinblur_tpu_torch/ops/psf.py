"""PSF rasterization, centering and cropping, batched in torch.

Port of ``detectinblur_tpu/ops/psf.py`` (``rasterize_psf`` :32,
``center_psf`` :87, ``psf_principal_components`` :135, ``crop_center``
:168, ``sample_psf`` :179, ``dilate_psf`` :205). Every function takes a
leading batch dimension.

The splat is one ``index_put_(..., accumulate=True)``. On CUDA its atomics
add in an order that changes from run to run, so a PSF's last bits vary
between runs; ``center_psf`` truncates the centroid, so a centroid that
sits within float noise of an integer can move the PSF by one pixel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from detectinblur_tpu_torch.ops.trajectory import (
    draw_trajectory_noise,
    sample_trajectory,
)
from detectinblur_tpu_torch.utils.device import resolve_device

# The reference's grids of trajectory exploration and exposure fraction
# (``detectinblur_tpu/ops/psf.py:229-232``): training draws from the
# BLUR grid, the evaluation sweep walks the EVAL grid.
BLUR_PARAMS: Sequence[float] = (0.005, 0.001, 0.00005)
BLUR_FRACTIONS: Sequence[float] = (1 / 18, 1 / 10, 1 / 5, 1 / 2, 1.0)
EVAL_PARAMS: Sequence[float] = (0.01, 0.005, 0.001, 0.00005)
EVAL_FRACTIONS: Sequence[float] = (1 / 100, 1 / 25, 1 / 10, 1 / 5, 1 / 2, 1.0)


def rasterize_psf(positions: torch.Tensor, canvas: int,
                  fraction) -> torch.Tensor:
    """Rasterize trajectories ``positions`` [B, T, 2] into [B, canvas,
    canvas] PSFs with bilinear (triangle) splatting.

    Only the first ``fraction * T`` samples contribute (``fraction`` a
    scalar or [B]), with the reference's fractional end-sample weights;
    the result is normalized by T, so each PSF sums to ~fraction. Splats
    that fall off the canvas are dropped (``mode="drop"`` in the JAX
    version).
    """
    B, T, _ = positions.shape
    device = positions.device
    t = torch.arange(T, dtype=torch.float32, device=device)
    f = torch.as_tensor(fraction, dtype=torch.float32, device=device) * T
    f = f.reshape(-1, 1) if f.ndim else f
    # The exposure starts at 0 (JAX prev_fraction, never set otherwise).
    p = torch.zeros((), device=device)

    # Reference elif-chain for the per-sample exposure weight.
    c1 = (f >= t) & (p < t - 1)
    c2 = (f >= t - 1) & (p < t - 1)
    c3 = (f >= t) & (p < t)
    c4 = (f >= t - 1) & (p < t)
    zero = torch.zeros((), device=device)
    t_prop = torch.where(
        c1, 1.0, torch.where(c2, f - (t - 1),
                             torch.where(c3, t - p,
                                         torch.where(c4, f - p, zero))))
    t_prop = t_prop.expand(B, T)

    px = positions[..., 0]
    py = positions[..., 1]
    m2 = torch.floor(px).clamp(1, canvas - 1).long()
    m1 = torch.floor(py).clamp(1, canvas - 1).long()
    M2 = m2 + 1
    M1 = m1 + 1

    def tri(x):
        return (1.0 - x.abs()).clamp(min=0.0)

    w_mm = t_prop * tri(px - m2) * tri(py - m1)
    w_mM = t_prop * tri(px - M2) * tri(py - m1)
    w_Mm = t_prop * tri(px - m2) * tri(py - M1)
    w_MM = t_prop * tri(px - M2) * tri(py - M1)

    rows = torch.cat([m1, m1, M1, M1], dim=1)
    cols = torch.cat([m2, M2, m2, M2], dim=1)
    ws = torch.cat([w_mm, w_mM, w_Mm, w_MM], dim=1)
    # Row/col `canvas` lies off the canvas: drop those splats.
    ws = torch.where((rows < canvas) & (cols < canvas), ws, zero)
    flat = (torch.arange(B, device=device)[:, None] * (canvas * canvas)
            + rows.clamp(max=canvas - 1) * canvas + cols.clamp(max=canvas - 1))

    psf = torch.zeros(B * canvas * canvas, dtype=torch.float32, device=device)
    psf.index_put_((flat.reshape(-1),), ws.reshape(-1), accumulate=True)
    return psf.reshape(B, canvas, canvas) / T


def center_psf(psf: torch.Tensor) -> torch.Tensor:
    """Roll each PSF [B, n, n] so its mass centroid sits at n/2: integer
    offsets truncated toward zero, circular roll (PSF.centerPSF)."""
    B, n, _ = psf.shape
    device = psf.device
    total = psf.sum(dim=(1, 2))
    coord = torch.arange(n, dtype=torch.float32, device=device)
    w = torch.where(psf > 0, psf, 0.0) / total.clamp(min=1e-20)[:, None, None]
    cx = (coord[None, None, :] * w).sum(dim=(1, 2))
    cy = (coord[None, :, None] * w).sum(dim=(1, 2))
    off_x = torch.trunc(cx - n / 2.0).long()
    off_y = torch.trunc(cy - n / 2.0).long()
    # jnp.roll(psf, -off): out[j] = in[(j + off) mod n].
    idx = torch.arange(n, device=device)
    rows = (idx[None, :] + off_y[:, None]) % n
    cols = (idx[None, :] + off_x[:, None]) % n
    b = torch.arange(B, device=device)[:, None, None]
    return psf[b, rows[:, :, None], cols[:, None, :]]


class PSFComponents(NamedTuple):
    theta_rad: torch.Tensor              # [B]
    scale_factor_lambda1: torch.Tensor   # [B]
    scale_factor_lambda2: torch.Tensor   # [B]


def psf_principal_components(psf: torch.Tensor) -> PSFComponents:
    """The Squint warp parameters of PSFs [B, n, n]: the PCA of each PSF's
    support (its nonzero pixels, unweighted). lambda1 >= lambda2 are the
    eigenvalues of the support's 2x2 covariance, theta = -atan2(lambda1 -
    var_x, -cov), and each scale factor is 1 - (sigmoid(sqrt(lambda) / 10)
    - 0.5) * 0.6."""
    n = psf.shape[-1]
    mask = (psf > 0).float()
    count = mask.sum(dim=(1, 2)).clamp(min=1.0)
    coord = torch.arange(n, dtype=torch.float32, device=psf.device)
    xs, ys = coord[None, None, :], coord[None, :, None]
    mean_x = (xs * mask).sum(dim=(1, 2)) / count
    mean_y = (ys * mask).sum(dim=(1, 2)) / count
    dx = (xs - mean_x[:, None, None]) * mask
    dy = (ys - mean_y[:, None, None]) * mask
    var_x = (dx * dx).sum(dim=(1, 2)) / count
    var_y = (dy * dy).sum(dim=(1, 2)) / count
    cov = (dx * dy).sum(dim=(1, 2)) / count
    mid = (var_x + var_y) / 2.0
    root = torch.sqrt(((var_x - var_y) / 2.0) ** 2 + cov ** 2)
    lam1, lam2 = mid + root, mid - root

    def scale_factor(lam):
        return 1.0 - (torch.sigmoid(torch.sqrt(lam.clamp(min=0.0)) / 10.0)
                      - 0.5) * 0.6

    theta = -torch.atan2(lam1 - var_x, -cov)
    return PSFComponents(theta, scale_factor(lam1), scale_factor(lam2))


def dilate_psf(psf: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Defocus dilation of PSFs [B, n, n] (``--dilate_psf``): each is
    filtered by a separable Gaussian of radius 13 and standard deviation
    ``sigma`` [B] (U(0, 3) in evaluation), rows then columns with zero
    padding, then divided by its max. Float32 denormals are flushed to
    zero at every product and sum, as XLA's CPU and the TPU flush them, so
    the support that the GT expansion reads (the nonzero pixels) is the
    JAX version's on every device."""
    radius = 13
    B, n, _ = psf.shape
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32,
                      device=psf.device)
    s = sigma.to(torch.float32).clamp(min=1e-6)
    k = torch.exp(-0.5 * (xs[None] / s[:, None]) ** 2)
    k = k / k.sum(dim=1, keepdim=True)                     # [B, 27]
    # One group per PSF: the images are the channels of a batch of one.
    k = _flush(k)
    out = _taps(psf, k, 1)
    out = _taps(out, k, 2)
    return _flush(out / out.amax(dim=(1, 2), keepdim=True).clamp(min=1e-20))


def _taps(x: torch.Tensor, k: torch.Tensor, dim: int) -> torch.Tensor:
    """The zero-padded correlation of ``x`` [B, n, n] along ``dim`` with
    per-image taps ``k`` [B, 2r + 1], one shifted product per tap, each
    product and partial sum with its denormals flushed."""
    r = (k.shape[1] - 1) // 2
    n = x.shape[dim]
    pad = [0, 0, 0, 0]
    pad[(2 - dim) * 2:(2 - dim) * 2 + 2] = [r, r]
    xp = F.pad(x, pad)
    out = torch.zeros_like(x)
    for t in range(2 * r + 1):
        out = _flush(out + _flush(k[:, t, None, None] * xp.narrow(dim, t, n)))
    return out


def _flush(x: torch.Tensor) -> torch.Tensor:
    """float32 denormals to zero."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, 0.0, x)


def crop_center(psf: torch.Tensor, size: int) -> torch.Tensor:
    """Crop the central [size, size] window of [..., n, n] PSFs."""
    c = psf.shape[-1]
    off = (c - size) // 2
    return psf[..., off:off + size, off:off + size]


def sample_psf(
    batch: int,
    expl,
    fraction,
    canvas: int = 256,
    iters: int = 2000,
    max_len: float = 96.0,
    center: bool = True,
    crop_to: Optional[int] = 128,
    generator: Optional[torch.Generator] = None,
    device=None,
    draws=None,
) -> torch.Tensor:
    """End-to-end PSF generation: trajectory -> rasterize -> center ->
    crop, for ``batch`` PSFs. Defaults match the reference's on-the-fly
    BlurImage transform (canvas 256, max_len 96, centered, cropped to the
    central 128x128).

    Randomness comes from ``generator`` (on ``device``), or from
    ``draws`` (a ``TrajectoryDraws``) when given.
    """
    if draws is None:
        draws = draw_trajectory_noise(batch, iters, generator,
                                      resolve_device(device))
    traj = sample_trajectory(draws, canvas=canvas, iters=iters,
                             max_len=max_len, expl=expl)
    psf = rasterize_psf(traj.positions, canvas=canvas, fraction=fraction)
    if center:
        psf = center_psf(psf)
    if crop_to is not None and crop_to < canvas:
        psf = crop_center(psf, crop_to)
    return psf
