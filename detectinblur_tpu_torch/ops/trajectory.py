"""Camera-shake trajectory sampler (Boracchi & Foi 2012), batched in torch.

Port of ``detectinblur_tpu/ops/trajectory.py:56``: the same stochastic
process, run for a whole batch of trajectories at once (one Python loop of
``iters - 1`` vectorised steps instead of a ``lax.scan`` under ``vmap``).

Random numbers come from an explicit ``torch.Generator``. The draws can
also be passed in as a ``TrajectoryDraws``, so that a test can feed the
exact numbers the JAX sampler drew and compare the dynamics one to one.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class TrajectoryDraws(NamedTuple):
    """Every random number one batch of trajectories consumes."""
    # [B, 4] uniforms on [0, 1): centripetal, big-shake prob, gaussian
    # shake, initial angle (the order of the JAX key split).
    hyper: torch.Tensor
    # [B, iters-1, 2] uniforms: big-shake test, inversion phase.
    step_uniform: torch.Tensor
    # [B, iters-1, 2] standard normals: the Gaussian shake.
    step_normal: torch.Tensor


class TrajectoryResult(NamedTuple):
    # Positions centered on the canvas, [B, iters, 2], (x, y) order.
    positions: torch.Tensor
    # Positions before recentering.
    raw_positions: torch.Tensor
    tot_length: torch.Tensor     # [B]
    big_shake_count: torch.Tensor  # [B] int32


def draw_trajectory_noise(batch: int, iters: int,
                          generator: Optional[torch.Generator],
                          device) -> TrajectoryDraws:
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    return TrajectoryDraws(
        torch.rand(batch, 4, **kw),
        torch.rand(batch, iters - 1, 2, **kw),
        torch.randn(batch, iters - 1, 2, **kw),
    )


def _rotate(v: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Complex multiply v * exp(i*angle) on [B, 2] float pairs."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([v[:, 0] * c - v[:, 1] * s,
                        v[:, 0] * s + v[:, 1] * c], dim=1)


def sample_trajectory(
    draws: TrajectoryDraws,
    canvas: int = 64,
    iters: int = 2000,
    max_len: float = 60.0,
    expl=0.005,
) -> TrajectoryResult:
    """Sample a batch of camera-shake trajectories from ``draws``
    (``draw_trajectory_noise`` makes them from a generator)."""
    hyper = draws.hyper
    device = hyper.device
    B = hyper.shape[0]
    centripetal = 0.7 * hyper[:, 0:1]
    prob_big_shake = 0.2 * hyper[:, 1]
    gaussian_shake = 10.0 * hyper[:, 2:3]
    init_angle = 2.0 * math.pi * hyper[:, 3]

    expl = torch.as_tensor(expl, dtype=torch.float32, device=device)
    expl = expl.expand(B) if expl.ndim == 0 else expl
    step_len = max_len / (iters - 1)

    v0 = torch.stack([torch.cos(init_angle), torch.sin(init_angle)], dim=1)
    # Reference: v = v0 * max_len/(iters-1), overridden to v0*expl when expl>0.
    v = torch.where((expl > 0)[:, None], v0 * expl[:, None], v0 * step_len)
    x = torch.zeros(B, 2, device=device)
    tot_len = torch.zeros(B, device=device)
    big_count = torch.zeros(B, dtype=torch.int32, device=device)
    big_thresh = prob_big_shake * expl
    expl2 = expl[:, None]

    xs = [x]
    for t in range(iters - 1):
        u = draws.step_uniform[:, t]
        is_big = u[:, 0] < big_thresh
        # Impulsive inversion: 2 * v * exp(i*(pi + U(-0.5, 0.5))).
        phase = math.pi + (u[:, 1] - 0.5)
        big_dir = 2.0 * _rotate(v, phase)
        next_direction = torch.where(is_big[:, None], big_dir,
                                     torch.zeros_like(big_dir))
        gauss = draws.step_normal[:, t]
        dv = next_direction + expl2 * (gaussian_shake * gauss
                                       - centripetal * x) * step_len
        v = v + dv
        v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True) * step_len
        x = x + v
        tot_len = tot_len + torch.linalg.vector_norm(v, dim=1)
        big_count = big_count + is_big.int()
        xs.append(x)

    raw = torch.stack(xs, dim=1)
    return TrajectoryResult(raw + canvas / 2.0, raw, tot_len, big_count)
