"""Stored PSF bank writer.

    python -m detectinblur_tpu_torch.cli.generate_psfs --output_path psfs \\
        [--num_psfs 12000 --slice_index 0 --num_workers 1] [--device cpu]

Port of ``detectinblur_tpu/cli/generate_psfs.py`` (the reference's
generate_PSFs.py), with its flags and defaults: for each blur parameter
``P{1-3}`` and exposure fraction ``E{0-4}`` (``ops/psf.py``'s
BLUR_PARAMS x BLUR_FRACTIONS) it samples ``num_psfs // num_workers``
camera-shake PSFs on a ``canvas`` of 256 with trajectories of up to
``max_len`` 96 pixels, centred and cut to the central ``crop`` of 128 (0
keeps the whole canvas), ``batch`` at a time with the batched
``sample_psf`` on the card, and writes each as an extensionless fp16
``np.save`` file ``P{p}E{e}/I{idx:06d}``, where ``idx`` counts on from
``slice_index * (num_psfs // num_workers)``, so that slices written by
separate runs fill one bank. ``--use_stored_psfs`` reads the bank back
(``data/blur_sampling.py::load_psf_bank``), as JAX's reader does.

The draws come from one ``torch.Generator`` on the device, seeded
``1337 * (slice_index + 1)``; JAX's ``jax.random`` streams differ, so
the two packages write different PSFs of the same distribution. Prints
the seconds and PSFs per second of each folder.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from detectinblur_tpu_torch.ops.psf import BLUR_FRACTIONS, BLUR_PARAMS, sample_psf
from detectinblur_tpu_torch.utils.device import resolve_device


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="stored PSF bank (PyTorch)")
    p.add_argument("--output_path", required=True)
    p.add_argument("--num_psfs", type=int, default=12000)
    p.add_argument("--slice_index", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--canvas", type=int, default=256)
    p.add_argument("--max_len", type=float, default=96.0)
    p.add_argument("--crop", type=int, default=128,
                   help="store the centered central crop (0 = full canvas)")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--device", default="cuda",
                   help="torch device to sample on (cuda, or cpu when asked)")
    return p


def main(argv=None) -> dict:
    """Write the bank; returns {"psfs": count written, "seconds": total}."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    per = args.num_psfs // args.num_workers
    start_idx = args.slice_index * per
    generator = torch.Generator(device=device).manual_seed(
        1337 * (args.slice_index + 1))
    total = 0.0
    for pi, param in enumerate(BLUR_PARAMS, start=1):
        for fi, fraction in enumerate(BLUR_FRACTIONS):
            folder = os.path.join(args.output_path, f"P{pi}E{fi}")
            os.makedirs(folder, exist_ok=True)
            t0 = time.perf_counter()
            for off in range(0, per, args.batch):
                n = min(args.batch, per - off)
                bank = sample_psf(
                    n, expl=torch.full((n,), param, device=device),
                    fraction=torch.full((n,), fraction, device=device),
                    canvas=args.canvas, max_len=args.max_len,
                    crop_to=args.crop or None, generator=generator,
                    device=device).to(torch.float16).cpu().numpy()
                for j in range(n):
                    # Extensionless, as the reference writes them.
                    with open(os.path.join(folder, f"I{start_idx + off + j:06d}"),
                              "wb") as f:
                        np.save(f, bank[j], allow_pickle=False)
            dt = time.perf_counter() - t0
            total += dt
            print(f"P{pi}E{fi}: {per} PSFs in {dt:.2f} s "
                  f"({per / dt if dt else 0.0:.1f} PSFs/s)")
    return {"psfs": per * len(BLUR_PARAMS) * len(BLUR_FRACTIONS),
            "seconds": total}


if __name__ == "__main__":
    main()
