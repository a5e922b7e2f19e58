"""RoIAlign, multi-scale (FPN) and single-level: shared geometry and the
plain torch version.

Port of ``detectinblur_tpu/ops/roi_align.py`` (``_bilinear_params`` :41,
``_level_geometry`` :57, ``roi_align_single_level`` :253,
``_assign_levels`` :353, ``multiscale_roi_align`` :365) with torch
``roi_align(aligned=False)`` semantics: roi size clamped to >= 1, 2x2
samples per bin averaged over a 7x7 grid, samples outside [-1, size]
contribute 0. Levels follow torchvision's LevelMapper,
``floor(4 + log2(sqrt(area)/224 + 1e-6))`` clamped to P2..P5. A
single-map detector pools every roi from its one level at that level's
scale (1/32): the same geometry with the level fixed at 0.

``roi_geometry`` computes each roi's level and its sample indices and
weights ONCE, in torch, from the level scales and sizes cached on the
device (``utils/device.py::device_constant``), so it never waits on the
host. Both the plain version here (the CPU path and the kernel's oracle)
and the CUDA kernel (``ops/roi_align_cuda.py``) read that same table, so
they can never disagree on a level boundary or a sample position; they
differ only in how they sum.

The plain version is the straightforward gather form (4 corner rows per
sample point), chunked over rois to bound its memory; it is not the TPU's
quad buffer. Its transpose, ``roi_align_backward_from_geometry``, scatters
each bin's cotangent back onto the same corners with ``index_add_``; it is
the CPU path of the gradient and the oracle of the CUDA backward kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from detectinblur_tpu_torch.utils.device import device_constant

LEVEL_SCALES = (0.25, 0.125, 0.0625, 0.03125)


class RoIGeometry(NamedTuple):
    """Per-roi sampling table, N = B*R rois, S = output_size *
    sampling_ratio sample positions per axis."""
    level: torch.Tensor   # [N] int32, 0..3 for P2..P5 (0 on one level)
    y_idx: torch.Tensor   # [N, S, 2] int32 (low, high) rows
    y_w: torch.Tensor     # [N, S, 2] f32 weights, 0 where out of range
    x_idx: torch.Tensor   # [N, S, 2] int32 (low, high) columns
    x_w: torch.Tensor     # [N, S, 2] f32


def assign_levels(boxes: torch.Tensor, canonical_scale: int = 224,
                  canonical_level: int = 4) -> torch.Tensor:
    """torchvision LevelMapper: [N, 4] boxes -> level index 0..3 int32."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    area = w.clamp(min=0) * h.clamp(min=0)
    lvl = torch.floor(canonical_level
                      + torch.log2(torch.sqrt(area) / canonical_scale + 1e-6))
    return (lvl.clamp(2, 5) - 2).int()


def _bilinear_params(coord: torch.Tensor, size: torch.Tensor):
    """torch roi_align bilinear sampling along one axis: (low, high,
    w_low, w_high), the weights zeroed where coord < -1 or coord > size."""
    in_range = (coord >= -1.0) & (coord <= size.to(coord.dtype))
    c = coord.clamp(min=0.0)
    low = torch.minimum(torch.floor(c).int(), (size - 1).int())
    high = torch.minimum(low + 1, (size - 1).int())
    # When low == size-1, torch sets the fractional coordinate to low.
    frac = torch.where(low >= size - 1, torch.zeros_like(c), c - low.to(c.dtype))
    zero = torch.zeros_like(c)
    return (torch.stack([low, high], -1),
            torch.stack([torch.where(in_range, 1.0 - frac, zero),
                         torch.where(in_range, frac, zero)], -1))


def roi_geometry(boxes: torch.Tensor, level_shapes: Sequence[Sequence[int]],
                 output_size: int = 7, sampling_ratio: int = 2,
                 spatial_scale: Optional[float] = None) -> RoIGeometry:
    """Level and per-axis sample table for [N, 4] boxes on levels of
    spatial sizes ``level_shapes``: [(H_l, W_l)] x 4 for P2..P5, or one
    level with its ``spatial_scale``, where every roi is on level 0 (JAX
    ``roi_align_single_level``: no level mapping)."""
    device = boxes.device
    boxes = boxes.float()
    s, g = output_size, sampling_ratio
    if len(level_shapes) == 1:
        if spatial_scale is None:
            raise ValueError("one level needs its spatial_scale")
        level = torch.zeros(boxes.shape[0], dtype=torch.int32, device=device)
        scale = torch.full((boxes.shape[0],), spatial_scale,
                           dtype=torch.float32, device=device)
    elif len(level_shapes) == 4 and spatial_scale is None:
        level = assign_levels(boxes)
        scale = device_constant(LEVEL_SCALES, device,
                                torch.float32)[level.long()]
    else:
        raise ValueError(f"expected 4 FPN levels, or one level with its "
                         f"scale; got {len(level_shapes)} levels and scale "
                         f"{spatial_scale}")
    lvl = level.long()
    sizes = device_constant(tuple(tuple(int(v) for v in hw)
                                  for hw in level_shapes), device, torch.int32)
    Hl = sizes[lvl, 0]
    Wl = sizes[lvl, 1]

    x1 = boxes[:, 0] * scale
    y1 = boxes[:, 1] * scale
    roi_w = (boxes[:, 2] * scale - x1).clamp(min=1.0)
    roi_h = (boxes[:, 3] * scale - y1).clamp(min=1.0)

    bin_idx = torch.arange(s, dtype=torch.float32, device=device)
    samp_idx = (torch.arange(g, dtype=torch.float32, device=device) + 0.5) / g
    grid = (bin_idx[:, None] + samp_idx[None, :]).reshape(-1)    # [s*g]
    ys = y1[:, None] + grid[None] * (roi_h / s)[:, None]
    xs = x1[:, None] + grid[None] * (roi_w / s)[:, None]
    y_idx, y_w = _bilinear_params(ys, Hl[:, None])
    x_idx, x_w = _bilinear_params(xs, Wl[:, None])
    return RoIGeometry(level, y_idx, y_w, x_idx, x_w)


def single_level_chunk(channels: int, rois: int, output_size: int = 7,
                       sampling_ratio: int = 2) -> int:
    """Rois a chunk of the plain single-level version, as JAX chunks them
    (``roi_align_single_level`` :270-275): ~64 MB of float32 corner
    samples, so 1280 channels and 1000 rois stay within memory."""
    per_roi = (output_size * sampling_ratio) ** 2 * 16 * channels
    return max(8, min(rois, int(64e6 / per_roi)))


def roi_align_from_geometry(features: Sequence[torch.Tensor],
                            geom: RoIGeometry, rois_per_image: int,
                            output_size: int = 7,
                            chunk: Optional[int] = None) -> torch.Tensor:
    """Plain gather-form RoIAlign: ``features`` the geometry's levels NHWC
    [B, H_l, W_l, C] (4, or 1), rois n of image n // rois_per_image ->
    [N, s, s, C] in the features' dtype, summed in float32. Rois go in
    chunks of ``chunk``: 512 over 4 levels, ``single_level_chunk`` over
    one."""
    C = features[0].shape[-1]
    s = output_size
    N = geom.level.shape[0]
    g = geom.y_idx.shape[1] // s
    if chunk is None:
        chunk = (single_level_chunk(C, N, s, g) if len(features) == 1
                 else 512)
    flat = torch.cat([f.reshape(-1, C) for f in features])
    sizes = [(f.shape[0], f.shape[1], f.shape[2]) for f in features]

    out = []
    for lo in range(0, N, chunk):
        hi = min(N, lo + chunk)
        rows, w = _corner_rows(geom, lo, hi, rois_per_image, sizes)
        vals = flat[rows.reshape(-1)].float().reshape(*rows.shape, C)
        samp = (vals * w[..., None]).sum(dim=(3, 4))          # [n, Sy, Sx, C]
        n = hi - lo
        binned = samp.reshape(n, s, g, s, g, C).mean(dim=(2, 4))
        out.append(binned.to(features[0].dtype))
    return torch.cat(out) if out else features[0].new_zeros(0, s, s, C)


def _corner_rows(geom: RoIGeometry, lo: int, hi: int, rois_per_image: int,
                 sizes: Sequence[Sequence[int]]):
    """Rows of rois lo..hi-1's sample corners in the level-concatenated
    [sum_l B*H_l*W_l, C] buffer, and their bilinear weights, both laid out
    [n, Sy, Sx, corner y, corner x]. ``sizes`` [(B, H_l, W_l)] x 4."""
    device = geom.level.device
    base, acc = [], 0
    for B_, H_, W_ in sizes:
        base.append(acc)
        acc += B_ * H_ * W_
    base_t = torch.tensor(base, device=device)
    hw_t = torch.tensor([H_ * W_ for _, H_, W_ in sizes], device=device)
    w_t = torch.tensor([W_ for _, _, W_ in sizes], device=device)
    lvl = geom.level[lo:hi].long()
    img = torch.arange(lo, hi, device=device) // rois_per_image
    row0 = base_t[lvl] + img * hw_t[lvl]                           # [n]
    W = w_t[lvl]
    yi = geom.y_idx[lo:hi].long()[:, :, None, :, None]
    xi = geom.x_idx[lo:hi].long()[:, None, :, None, :]
    wy = geom.y_w[lo:hi][:, :, None, :, None]
    wx = geom.x_w[lo:hi][:, None, :, None, :]
    rows = row0[:, None, None, None, None] + yi * W[:, None, None, None, None] + xi
    return rows, wy * wx


def roi_align_backward_from_geometry(dout: torch.Tensor, geom: RoIGeometry,
                                     rois_per_image: int,
                                     level_shapes: Sequence[Sequence[int]],
                                     chunk: Optional[int] = None):
    """Plain transpose of ``roi_align_from_geometry``: the cotangent
    ``dout`` [N, s, s, C] (any float dtype) -> one float32 gradient
    [B, H_l, W_l, C] per level of ``level_shapes``. Each bin's cotangent
    goes to the 4 corners of each of its g x g samples with weight
    ``y_w * x_w / g**2``, accumulated with ``index_add_`` in float32. Rois
    go in chunks of 256 over 4 levels, ``single_level_chunk`` over one."""
    N, s, _, C = dout.shape
    g = geom.y_idx.shape[1] // s
    if chunk is None:
        chunk = (single_level_chunk(C, N, s, g) if len(level_shapes) == 1
                 else 256)
    B = N // rois_per_image
    sizes = [(B, int(h), int(w)) for h, w in level_shapes]
    flat = torch.zeros(sum(b * h * w for b, h, w in sizes), C,
                       dtype=torch.float32, device=dout.device)
    for lo in range(0, N, chunk):
        hi = min(N, lo + chunk)
        rows, w = _corner_rows(geom, lo, hi, rois_per_image, sizes)
        n = hi - lo
        d = dout[lo:hi].float() / (g * g)                    # [n, s, s, C]
        # Every sample of bin (i, j) sees that bin's cotangent.
        d = d[:, :, None, :, None, :].expand(n, s, g, s, g, C)
        d = d.reshape(n, s * g, s * g, C)
        vals = d[:, :, :, None, None, :] * w[..., None]   # [n,Sy,Sx,2,2,C]
        flat.index_add_(0, rows.reshape(-1), vals.reshape(-1, C))
    out, start = [], 0
    for b, h, w in sizes:
        out.append(flat[start:start + b * h * w].view(b, h, w, C))
        start += b * h * w
    return out


def multiscale_roi_align(features: Sequence[torch.Tensor],
                         boxes: torch.Tensor, output_size: int = 7,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """Plain FPN RoIAlign over P2..P5.

    Args:
      features: 4 levels NHWC [B, H_l, W_l, C] at strides 4/8/16/32.
      boxes: [B, R, 4] xyxy in (resized) input-image coordinates.

    Returns [B, R, output_size, output_size, C].
    """
    assert len(features) == 4
    B, R = boxes.shape[:2]
    geom = roi_geometry(boxes.reshape(-1, 4),
                        [f.shape[1:3] for f in features],
                        output_size, sampling_ratio)
    out = roi_align_from_geometry(features, geom, R, output_size)
    return out.reshape(B, R, output_size, output_size, -1)


def roi_align_single_level(feature: torch.Tensor, boxes: torch.Tensor,
                           spatial_scale: float, output_size: int = 7,
                           sampling_ratio: int = 2) -> torch.Tensor:
    """Plain single-level RoIAlign, JAX ``roi_align_single_level``'s
    signature: ``feature`` [H, W, C], ``boxes`` [R, 4] xyxy in input
    coordinates, pooled at ``spatial_scale`` -> [R, s, s, C]."""
    geom = roi_geometry(boxes, [feature.shape[:2]], output_size,
                        sampling_ratio, spatial_scale)
    return roi_align_from_geometry([feature[None]], geom, boxes.shape[0],
                                   output_size)
