"""Host-side blur decisions and PSF banks.

Port of ``detectinblur_tpu/data/blur_sampling.py``. The host draws the
cheap per-image decisions (blur or not by the regime's probability, the
(param, fraction) indices with the LEHE weighting, the bank index) from a
numpy RNG, exactly as the JAX package does, so both packages make the
same decisions from the same seed. The PSFs themselves come from a bank
made in one batched ``sample_psf`` sweep on the card
(``generate_psf_bank``) or read from the reference's on-disk layout
(``load_psf_bank``); blur and box expansion happen in the step, on the
card.

The regime probabilities follow train.py:139-144 of the reference (0.75
low / 1.0 high / 0.9 default) and the LEHE weights transforms.py:238-263.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from detectinblur_tpu_torch.ops.psf import BLUR_FRACTIONS, BLUR_PARAMS, sample_psf

# The reference's LEHE weights are joint shares (they sum to the blur
# share 1 - 0.0625), so the fraction draw divides them by their sum: no
# blur 6.25%, each low exposure 6.25%, each high exposure 37.5%. JAX
# passes them to rng.choice as they are, which raises.
LEHE_FRACTION_WEIGHTS = (0.0625, 0.0625, 0.0625, 0.375, 0.375)


@dataclass
class BlurPolicy:
    prob: float = 0.9
    blur_type: Optional[float] = None       # fixed param value (eval sweeps)
    blur_exposure: Optional[float] = None   # fixed fraction value
    low_exposure: bool = False
    high_exposure: bool = False
    lehe_blur_seg: bool = False

    @staticmethod
    def training_default(low: bool = False, high: bool = False) -> "BlurPolicy":
        prob = 0.75 if low else (1.0 if high else 0.9)
        return BlurPolicy(prob=prob, low_exposure=low, high_exposure=high)


@dataclass
class BlurDecision:
    blurring: bool
    param_index: int       # -1 when not blurring
    fraction_index: int    # -1 when negligible exposure / not blurring
    psf_index: int         # index into the (param, fraction) PSF bank


def sample_blur_decision(rng: np.random.Generator, policy: BlurPolicy,
                         bank_size: int = 12000) -> BlurDecision:
    threshold = (1 - 0.0625) if policy.lehe_blur_seg else policy.prob
    if rng.random() >= threshold:
        return BlurDecision(False, -1, -1, 0)

    if policy.blur_exposure is not None:
        diffs = np.abs(np.asarray(BLUR_FRACTIONS) - policy.blur_exposure)
        fraction_index = int(np.argmin(diffs))
        if policy.blur_exposure < 1 / 90:   # legacy negligible-exposure tag
            fraction_index = -1
    elif policy.high_exposure:
        fraction_index = int(rng.integers(3, 5))
    elif policy.low_exposure:
        fraction_index = int(rng.integers(0, 3))
    elif policy.lehe_blur_seg:
        w = np.asarray(LEHE_FRACTION_WEIGHTS)
        fraction_index = int(rng.choice(5, p=w / w.sum()))
    else:
        fraction_index = int(rng.integers(0, 5))

    if policy.blur_type is not None:
        diffs = np.abs(np.asarray(BLUR_PARAMS) - policy.blur_type)
        param_index = int(np.argmin(diffs))
    else:
        param_index = int(rng.integers(0, len(BLUR_PARAMS)))

    return BlurDecision(True, param_index, fraction_index,
                        int(rng.integers(0, bank_size)))


def generate_psf_bank(
    generator: torch.Generator,
    bank_size: int = 256,
    params: Sequence[float] = BLUR_PARAMS,
    fractions: Sequence[float] = BLUR_FRACTIONS,
    iters: int = 2000,
    batch: int = 1024,
    center: bool = True,
) -> np.ndarray:
    """A PSF bank [P, F, bank_size, 128, 128] float32, on the host.

    The PSFs are sampled on ``generator``'s device, ``batch`` at a time
    across the (param, fraction) bins (one vectorised trajectory walk per
    chunk), then copied to the host, where the loader picks each image's
    PSF. ``center=False`` keeps them uncentered (--dont_center_psf)."""
    device = generator.device
    grid = torch.tensor([(p, f) for p in params for f in fractions
                         for _ in range(bank_size)], dtype=torch.float32,
                        device=device)
    chunks = []
    for start in range(0, len(grid), batch):
        expl, fraction = grid[start:start + batch].unbind(1)
        chunks.append(sample_psf(len(expl), expl=expl, fraction=fraction,
                                 iters=iters, center=center,
                                 generator=generator, device=device).cpu())
    return torch.cat(chunks).reshape(
        len(params), len(fractions), bank_size, 128, 128).numpy()


def load_psf_bank(
    directory: str,
    bank_size: Optional[int] = None,
    n_params: int = 3,
    n_fractions: int = 5,
    max_bank: int = 2048,
    epoch: int = 0,
) -> np.ndarray:
    """Load a stored PSF bank from the reference's on-disk layout
    (--use_stored_psfs --stored_psf_directory): folders ``P{1-3}E{0-4}``
    of fp16 ``I{idx:06d}`` files written extensionless via np.save on an
    open handle (``.npy``-suffixed files are accepted too), center-cropped
    256 -> 128 as the reference's BlurImage transform does. Returns
    [P, F, n, 128, 128] float32.

    ``bank_size=None`` autodetects the smallest per-folder count. The bank
    is stride-subsampled to at most ``max_bank`` per bin; ``epoch`` offsets
    the stride (epoch % stride), so reloading per epoch walks disjoint
    slices of the whole stored bank."""
    if bank_size is None:
        counts = []
        for pi in range(n_params):
            for fi in range(n_fractions):
                folder = os.path.join(directory, f"P{pi + 1}E{fi}")
                if not os.path.isdir(folder):
                    raise FileNotFoundError(
                        f"stored PSF bank folder missing: {folder}")
                counts.append(sum(1 for f_ in os.listdir(folder)
                                  if f_.startswith("I")))
        bank_size = min(counts)
        if bank_size == 0:
            raise FileNotFoundError(f"no PSF files under {directory}/P*E*")
    take = min(bank_size, max_bank)
    stride = max(1, bank_size // take)
    offset = epoch % stride
    indices = list(range(offset, offset + stride * take, stride))[:take]

    out = np.zeros((n_params, n_fractions, take, 128, 128), np.float32)
    for pi in range(n_params):
        for fi in range(n_fractions):
            folder = os.path.join(directory, f"P{pi + 1}E{fi}")
            for j, i in enumerate(indices):
                path = os.path.join(folder, f"I{i:06d}")
                if not os.path.exists(path):
                    path += ".npy"
                if not os.path.exists(path):
                    raise FileNotFoundError(
                        f"stored PSF bank incomplete: {path} "
                        f"(expected {bank_size} PSFs per P*E* folder)")
                psf = np.load(path).astype(np.float32)
                if psf.shape[0] > 128:   # 256-canvas files: central crop
                    o = (psf.shape[0] - 128) // 2
                    psf = psf[o:o + 128, o:o + 128]
                out[pi, fi, j] = psf
    return out
