"""The one generator of every traffic mix: a mix is a data file
(``benchmark/traffic/<mix>.json``) of parameters, and this turns it and a
seed into the cell's inputs, on the device.

* ``images``: ``pool`` batches of ``batch`` frames of ``src_hw``, smooth
  low-frequency content (uniform noise at ``low_hw`` upsampled
  bilinearly, as ``bench.pipeline``'s JPEGs), float32 0..1;
* ``psfs``: one camera-shake PSF a frame, its (exploration, fraction)
  drawn from the paper's ``psf_grid`` (``reference/psf.py``), made on the
  CPU so that a seed gives the same PSFs bit for bit;
* ``gt`` (training mixes): ``gt.min``..``gt.max`` boxes a frame padded to
  ``gt.slots``, corners U(0, w/2) x U(0, h/2), sides U(``gt.min_side``,
  w/3) x U(.., h/3), labels U{1..classes-1}.

Every seed gives the same sizes; only the content and its order change.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.harness import sub_seed
from benchmark.reference.psf import sample_psfs


def frames(mix: dict, seed: int, device) -> torch.Tensor:
    """[pool, batch, H, W, 3] float32 on ``device``."""
    n = mix["pool"] * mix["batch"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    low = torch.rand(n, 3, *mix["low_hw"], generator=gen, device=device)
    up = F.interpolate(low, size=tuple(mix["src_hw"]), mode="bilinear",
                       align_corners=False)
    return up.permute(0, 2, 3, 1).reshape(
        mix["pool"], mix["batch"], *mix["src_hw"], 3).contiguous()


def psfs(mix: dict, seed: int, device) -> torch.Tensor:
    """[pool, batch, 128, 128] float32 on ``device``."""
    gen = torch.Generator().manual_seed(sub_seed(seed, 2))
    out = sample_psfs(gen, mix["pool"] * mix["batch"], mix["psf_grid"])
    return out.reshape(mix["pool"], mix["batch"], *out.shape[1:]).to(device)


def gt(mix: dict, seed: int, classes: int, device):
    """(boxes [pool, batch, slots, 4], labels int64, valid bool)."""
    g = mix["gt"]
    P, B, S = mix["pool"], mix["batch"], g["slots"]
    h, w = mix["src_hw"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 3))

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(P, B, S, generator=gen,
                                           device=device)

    x1, y1 = u(0, w // 2), u(0, h // 2)
    boxes = torch.stack([x1, y1, x1 + u(g["min_side"], w // 3),
                         y1 + u(g["min_side"], h // 3)], dim=-1)
    labels = torch.randint(1, classes, (P, B, S), generator=gen,
                           device=device)
    count = torch.randint(g["min"], g["max"] + 1, (P, B, 1), generator=gen,
                          device=device)
    valid = torch.arange(S, device=device) < count
    return boxes, labels, valid


def hw(mix: dict) -> np.ndarray:
    """Valid sizes of a batch [batch, 2] (every frame fills its canvas)."""
    return np.tile(np.asarray([mix["src_hw"]], np.int64), (mix["batch"], 1))
