"""Camera-shake PSFs (Boracchi and Foi 2012): a trajectory sampled as a
random walk, rasterized by bilinear splatting, centered and cropped.

A frozen copy of the port's ``ops/trajectory.py`` and of ``sample_psf``
and its helpers in ``ops/psf.py``, with which the benchmark makes every
cell's PSFs. Run it on the CPU: the splat's ``index_put_`` adds in a fixed
order there, so a seed gives the same PSFs bit for bit.
"""

from __future__ import annotations

import math

import torch

# The reference's grids (exploration, exposure fraction): training draws
# from the first pair, the evaluation sweep walks the second.
TRAIN_GRID = ((0.005, 0.001, 0.00005), (1 / 18, 1 / 10, 1 / 5, 1 / 2, 1.0))
EVAL_GRID = ((0.01, 0.005, 0.001, 0.00005),
             (1 / 100, 1 / 25, 1 / 10, 1 / 5, 1 / 2, 1.0))
GRIDS = {"train": TRAIN_GRID, "eval": EVAL_GRID}


def _rotate(v, angle):
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([v[:, 0] * c - v[:, 1] * s,
                        v[:, 0] * s + v[:, 1] * c], dim=1)


def trajectory(generator, batch, expl, canvas=256, iters=2000, max_len=96.0):
    """[B, iters, 2] positions (x, y) centered on the canvas; ``expl`` [B]."""
    kw = dict(generator=generator, dtype=torch.float32)
    hyper = torch.rand(batch, 4, **kw)
    step_u = torch.rand(batch, iters - 1, 2, **kw)
    step_n = torch.randn(batch, iters - 1, 2, **kw)
    centripetal = 0.7 * hyper[:, 0:1]
    prob_big = 0.2 * hyper[:, 1]
    gaussian = 10.0 * hyper[:, 2:3]
    angle0 = 2.0 * math.pi * hyper[:, 3]
    step = max_len / (iters - 1)
    v0 = torch.stack([torch.cos(angle0), torch.sin(angle0)], dim=1)
    v = torch.where((expl > 0)[:, None], v0 * expl[:, None], v0 * step)
    x = torch.zeros(batch, 2)
    big_thresh = prob_big * expl
    xs = [x]
    for t in range(iters - 1):
        u = step_u[:, t]
        big = 2.0 * _rotate(v, math.pi + (u[:, 1] - 0.5))
        nxt = torch.where((u[:, 0] < big_thresh)[:, None], big,
                          torch.zeros_like(big))
        v = v + nxt + expl[:, None] * (gaussian * step_n[:, t]
                                       - centripetal * x) * step
        v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True) * step
        x = x + v
        xs.append(x)
    return torch.stack(xs, dim=1) + canvas / 2.0


def rasterize(positions, canvas, fraction):
    """Bilinear splat of the first ``fraction * T`` samples (the
    reference's fractional end weights), normalized by T."""
    B, T, _ = positions.shape
    t = torch.arange(T, dtype=torch.float32)
    f = (fraction * T).reshape(-1, 1)
    zero = torch.zeros(())
    p = zero
    w_t = torch.where(
        (f >= t) & (p < t - 1), 1.0,
        torch.where((f >= t - 1) & (p < t - 1), f - (t - 1),
                    torch.where((f >= t) & (p < t), t - p,
                                torch.where((f >= t - 1) & (p < t), f - p,
                                            zero)))).expand(B, T)
    px, py = positions[..., 0], positions[..., 1]
    m2 = torch.floor(px).clamp(1, canvas - 1).long()
    m1 = torch.floor(py).clamp(1, canvas - 1).long()

    def tri(d):
        return (1.0 - d.abs()).clamp(min=0.0)

    rows = torch.cat([m1, m1, m1 + 1, m1 + 1], dim=1)
    cols = torch.cat([m2, m2 + 1, m2, m2 + 1], dim=1)
    ws = torch.cat([w_t * tri(px - m2) * tri(py - m1),
                    w_t * tri(px - m2 - 1) * tri(py - m1),
                    w_t * tri(px - m2) * tri(py - m1 - 1),
                    w_t * tri(px - m2 - 1) * tri(py - m1 - 1)], dim=1)
    ws = torch.where((rows < canvas) & (cols < canvas), ws, zero)
    flat = (torch.arange(B)[:, None] * canvas * canvas
            + rows.clamp(max=canvas - 1) * canvas + cols.clamp(max=canvas - 1))
    psf = torch.zeros(B * canvas * canvas)
    psf.index_put_((flat.reshape(-1),), ws.reshape(-1), accumulate=True)
    return psf.reshape(B, canvas, canvas) / T


def center(psf):
    """Roll each PSF so its mass centroid sits at n/2 (offsets truncated)."""
    B, n, _ = psf.shape
    coord = torch.arange(n, dtype=torch.float32)
    w = torch.where(psf > 0, psf, 0.0) / psf.sum(dim=(1, 2)).clamp(
        min=1e-20)[:, None, None]
    off_x = torch.trunc((coord[None, None, :] * w).sum(dim=(1, 2)) - n / 2)
    off_y = torch.trunc((coord[None, :, None] * w).sum(dim=(1, 2)) - n / 2)
    idx = torch.arange(n)
    rows = (idx[None] + off_y.long()[:, None]) % n
    cols = (idx[None] + off_x.long()[:, None]) % n
    return psf[torch.arange(B)[:, None, None], rows[:, :, None],
               cols[:, None, :]]


def sample_psfs(generator: torch.Generator, n: int, grid: str,
                canvas: int = 256, crop: int = 128) -> torch.Tensor:
    """``n`` PSFs [n, crop, crop] on the CPU, each with an (exploration,
    fraction) pair drawn uniformly from the ``grid`` ("train" or "eval")."""
    expls, fracs = GRIDS[grid]
    pick_e = torch.randint(len(expls), (n,), generator=generator)
    pick_f = torch.randint(len(fracs), (n,), generator=generator)
    expl = torch.tensor(expls, dtype=torch.float32)[pick_e]
    frac = torch.tensor(fracs, dtype=torch.float32)[pick_f]
    psf = center(rasterize(trajectory(generator, n, expl, canvas), canvas,
                           frac))
    off = (canvas - crop) // 2
    return psf[:, off:off + crop, off:off + crop].contiguous()
