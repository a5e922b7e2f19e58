"""PSF rasterization, centering and cropping, batched in torch.

Port of ``detectinblur_tpu/ops/psf.py`` (``rasterize_psf`` :32,
``center_psf`` :87, ``crop_center`` :168, ``sample_psf`` :179). Every
function takes a leading batch dimension.

The splat is one ``index_put_(..., accumulate=True)``. On CUDA its atomics
add in an order that changes from run to run, so a PSF's last bits vary
between runs; ``center_psf`` truncates the centroid, so a centroid that
sits within float noise of an integer can move the PSF by one pixel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

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
