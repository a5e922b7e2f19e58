"""Batched motion-blur application (port of ``detectinblur_tpu/ops/blur.py``).

The reference's roll loop is a circular convolution of the padded image
with the PSF centered at (k/2 - 1, k/2 - 1), computed here as one batched
``torch.fft.rfft2`` -> multiply -> ``irfft2`` at the same padded sizes as
the JAX version, so the circular wrap lands where it does there.

Padding semantics match the reference:
  * k=128: pad (63, 64) per axis; 'reflect' if both spatial dims >= 64
    else zero-fill.
  * k=256: pad (127, 128) per axis; 'replicate' (edge) always.

``dft_blur`` is not ported: it existed only because FFTs were slow on the
TPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_mode(k: int, h: int, w: int) -> str:
    if k > 129:
        return "edge"
    return "reflect" if (h >= 64 and w >= 64) else "constant"


def _fast_fft_size(n: int) -> int:
    """Next 2/3/5-smooth size >= n."""
    best = 1 << (n - 1).bit_length()
    m = n
    while m <= best:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1
    return best


def _reflect_idx(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """np.pad('reflect') source index for any integer coordinate ``x``
    into an ``n``-long axis (period 2n-2, no edge repeat)."""
    p = (2 * n - 2).clamp(min=1)
    m = torch.remainder(x, p)
    return torch.where(m < n, m, p - m)


def pad_for_blur(images: torch.Tensor, k: int, hw=None) -> torch.Tensor:
    """Blur padding for a batch [B, C, Hc, Wc] -> [B, C, Hc+k-1, Wc+k-1].

    ``hw=None``: the whole canvas is the image. ``hw`` [B, 2]: image b
    occupies the top-left ``hw[b]`` of the canvas and its padding is
    computed against that valid region (reflect for k=128 with h, w >= 64,
    zeros for smaller images, edge for k=256), as the reference pads each
    image at its own size.
    """
    c = k // 2 - 1
    B, C, Hc, Wc = images.shape
    device = images.device
    if hw is None:
        mode = _pad_mode(k, Hc, Wc)
        pads = (c, k - c - 1, c, k - c - 1)
        if mode == "constant":
            return F.pad(images, pads)
        if mode == "edge":
            return F.pad(images, pads, mode="replicate")
        if min(Hc, Wc) > k - c - 1:
            return F.pad(images, pads, mode="reflect")
        # F.pad's reflect needs pad < size; np.pad's reflect does not.
        hw = torch.tensor([[Hc, Wc]] * B, device=device)
    hw = torch.as_tensor(hw, device=device).long()
    h, w = hw[:, 0:1], hw[:, 1:2]                        # [B, 1]
    xs_r = torch.arange(Hc + k - 1, device=device)[None] - c
    xs_c = torch.arange(Wc + k - 1, device=device)[None] - c
    if k > 129:
        ridx = torch.minimum(xs_r.clamp(min=0), h - 1)
        cidx = torch.minimum(xs_c.clamp(min=0), w - 1)
        refl = torch.ones(B, 1, dtype=torch.bool, device=device)
    else:
        refl = (h >= 64) & (w >= 64)
        ridx = torch.where(refl, _reflect_idx(xs_r, h),
                           torch.minimum(xs_r.clamp(min=0), h - 1))
        cidx = torch.where(refl, _reflect_idx(xs_c, w),
                           torch.minimum(xs_c.clamp(min=0), w - 1))
    b = torch.arange(B, device=device)[:, None, None]
    g = images.permute(0, 2, 3, 1)[b, ridx[:, :, None], cidx[:, None, :]]
    g = g.permute(0, 3, 1, 2)                           # [B, C, Hp, Wp]
    if k > 129:
        return g
    # Small images pad with zeros (constant mode), not clamped edges.
    inb = (((xs_r >= 0) & (xs_r < h))[:, :, None]
           & ((xs_c >= 0) & (xs_c < w))[:, None, :])
    keep = refl[:, :, None] | inb
    return torch.where(keep[:, None], g, torch.zeros_like(g))


def fft_blur(images: torch.Tensor, psfs: torch.Tensor, exact: bool = False,
             hw=None) -> torch.Tensor:
    """Blur ``images`` [B, C, H, W] with ``psfs`` [B, k, k] (k in {128,
    256}).

    ``exact=True`` reproduces the reference roll-loop circularity exactly
    (padded size H+k-1); ``exact=False`` rounds the FFT size up to a
    2/3/5-smooth value (differs only in the wraparound of the outermost
    pixel ring). ``hw`` marks each image's valid top-left region.
    """
    k = psfs.shape[-1]
    B = images.shape[0]
    h, w = images.shape[-2], images.shape[-1]
    c = k // 2 - 1
    mode = _pad_mode(k, h, w)

    padded = pad_for_blur(images, k, hw)
    hp, wp = padded.shape[-2], padded.shape[-1]
    if not exact:
        fh, fw = _fast_fft_size(hp), _fast_fft_size(wp)
        if (fh, fw) != (hp, wp):
            # Same mode as the blur padding; it only moves where the
            # circular wrap lands (inside the cropped-away margin).
            extra = (0, fw - wp, 0, fh - hp)
            padded = (F.pad(padded, extra) if mode == "constant"
                      else F.pad(padded, extra, mode="replicate"))
            hp, wp = fh, fw

    kern = psfs.new_zeros(B, hp, wp)
    kern[:, :k, :k] = psfs
    # Center tap (c, c) of the PSF must land at index (0, 0).
    kern = torch.roll(kern, shifts=(-c, -c), dims=(1, 2))

    img_f = torch.fft.rfft2(padded.float())
    kern_f = torch.fft.rfft2(kern.float())
    out = torch.fft.irfft2(img_f * kern_f[:, None], s=(hp, wp))
    return out[..., c:c + h, c:c + w].to(images.dtype)


def apply_psf_blur(images: torch.Tensor, psfs: torch.Tensor,
                   exact: bool = False, hw=None) -> torch.Tensor:
    """Blur a batch with its PSFs, each normalized to unit sum first (as
    blur_image_list does, blur_functions.py:98)."""
    psfs = psfs / psfs.sum(dim=(-2, -1), keepdim=True).clamp(min=1e-20)
    return fft_blur(images, psfs, exact=exact, hw=hw)


def batched_blur(images: torch.Tensor, psfs: torch.Tensor,
                 blurring: torch.Tensor, exact: bool = False,
                 hw=None) -> torch.Tensor:
    """Blur a batch: images [B, C, H, W], psfs [B, k, k], blurring [B]
    bool. Non-blurring entries pass through unchanged.

    ``hw`` [B, 2] gives each image's valid extent on the canvas: the blur
    pads against the valid region, and the canvas outside it is re-zeroed
    afterwards (the blurred reflect-extension must not leak into the batch
    padding).
    """
    blurred = apply_psf_blur(images, psfs, exact=exact, hw=hw)
    on = blurring.to(images.device).bool()[:, None, None, None]
    if hw is not None:
        Hc, Wc = images.shape[-2], images.shape[-1]
        hw_t = torch.as_tensor(hw, device=images.device).long()
        rows = torch.arange(Hc, device=images.device)
        cols = torch.arange(Wc, device=images.device)
        valid = ((rows[None, :, None] < hw_t[:, 0, None, None])
                 & (cols[None, None, :] < hw_t[:, 1, None, None]))
        on = on & valid[:, None]
    return torch.where(on, blurred, images)
