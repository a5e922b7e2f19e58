"""Plain torch operations of the reference detector: boxes, greedy NMS,
anchors, the blur, the resize into the model bucket and RoIAlign.

A frozen copy of the plain paths of the port's ``ops/boxes.py``,
``ops/nms.py`` (``_alive_sorted_plain`` and the functions over it),
``models/anchors.py``, ``ops/blur.py``, ``models/detection_transform.py``
and ``ops/roi_align.py``, made so that the benchmark's yardstick does not
move when the program does. Nothing here launches a kernel of the program:
NMS is the blocked fixpoint on any device, RoIAlign the gather form, whose
gradient autograd takes.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LEVEL_SCALES = (0.25, 0.125, 0.0625, 0.03125)


# ------------------------------------------------------------------ boxes
def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1, boxes2):
    """[..., N, 4] x [..., M, 4] xyxy -> [..., N, M]."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=1e-12)


def clip_boxes(boxes, height, width):
    h = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([torch.minimum(torch.maximum(x1, zero), w),
                        torch.minimum(torch.maximum(y1, zero), h),
                        torch.minimum(torch.maximum(x2, zero), w),
                        torch.minimum(torch.maximum(y2, zero), h)], dim=-1)


def encode_boxes(reference, proposals, weights):
    wx, wy, ww, wh = weights
    px1, py1, px2, py2 = proposals.unbind(-1)
    gx1, gy1, gx2, gy2 = reference.unbind(-1)
    pw, ph = px2 - px1, py2 - py1
    gw, gh = gx2 - gx1, gy2 - gy1
    pcx, pcy = px1 + 0.5 * pw, py1 + 0.5 * ph
    gcx, gcy = gx1 + 0.5 * gw, gy1 + 0.5 * gh
    return torch.stack([wx * (gcx - pcx) / pw, wy * (gcy - pcy) / ph,
                        ww * torch.log(gw / pw), wh * torch.log(gh / ph)],
                       dim=-1)


def decode_boxes(deltas, boxes, weights):
    wx, wy, ww, wh = weights
    x1, y1, x2, y2 = boxes.unbind(-1)
    w, h = x2 - x1, y2 - y1
    cx, cy = x1 + 0.5 * w, y1 + 0.5 * h
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)
    pcx, pcy = dx * w + cx, dy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def fix_box_squeeze(boxes, height, width):
    """Clamp into [0, w-1] x [0, h-1], push degenerate edges 1 px apart,
    clamp again (the reference's ``fix_bounding_box_squeeze``)."""
    h = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device) - 1
    w = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device) - 1
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def clamp(x1, y1, x2, y2):
        return (torch.minimum(torch.maximum(x1, zero), w),
                torch.minimum(torch.maximum(y1, zero), h),
                torch.minimum(torch.maximum(x2, zero), w),
                torch.minimum(torch.maximum(y2, zero), h))

    x1, y1, x2, y2 = clamp(*boxes.unbind(-1))
    bad_x = (x1 >= x2).to(boxes.dtype)
    bad_y = (y1 >= y2).to(boxes.dtype)
    return torch.stack(clamp(x1 - bad_x, y1 - bad_y, x2 + bad_x, y2 + bad_y),
                       dim=-1)


def expand_boxes_by_psf(boxes, psfs, blurring, height, width):
    """GT boxes [B, G, 4] grown by the extent of their image's 128x128 PSF
    support around pixel (63, 63), then the squeeze fix."""
    mask = psfs > 0
    coord = torch.arange(128, dtype=torch.float32, device=psfs.device)
    big = 1e9
    xs = torch.where(mask, coord[None, None, :], big)
    ys = torch.where(mask, coord[None, :, None], big)
    left = xs.amin(dim=(1, 2)) - 63.0
    top = ys.amin(dim=(1, 2)) - 63.0
    right = torch.where(mask, coord[None, None, :], -big).amax(dim=(1, 2)) - 63
    bottom = torch.where(mask, coord[None, :, None], -big).amax(dim=(1, 2)) - 63
    shift = torch.stack([left, top, right, bottom], dim=-1)[:, None]
    expanded = fix_box_squeeze(boxes + shift, height[:, None], width[:, None])
    return torch.where(blurring.bool()[:, None, None], expanded, boxes)


# ------------------------------------------------------------------- NMS
def _killed(alive, sup):
    return (alive[:, :, None] & sup).any(dim=1)


def alive_sorted(sboxes, salive, thr, block: int = 128):
    """Greedy-NMS aliveness over score-descending boxes [M, N, 4]: within
    a block the suppression operator is iterated to its fixpoint (rank k
    is exact after k steps), then the block's survivors suppress every
    later box."""
    M, N = salive.shape
    n_blocks = (N + block - 1) // block
    pad = n_blocks * block - N
    sboxes = sboxes.float()
    if pad:
        sboxes = torch.cat([sboxes, sboxes.new_zeros(M, pad, 4)], dim=1)
        salive = torch.cat([salive, salive.new_zeros(M, pad)], dim=1)
    alive = salive.clone()
    ar = torch.arange(block, device=salive.device)
    tri = ar[:, None] < ar[None, :]
    for i in range(n_blocks):
        lo, hi = i * block, (i + 1) * block
        blk = sboxes[:, lo:hi]
        blk_alive = alive[:, lo:hi]
        sup = (box_iou(blk, blk) > thr) & tri
        prev, cur = blk_alive, blk_alive & ~_killed(blk_alive, sup)
        while bool((cur != prev).any()):
            prev, cur = cur, blk_alive & ~_killed(cur, sup)
        if hi < alive.shape[1]:
            alive[:, hi:] &= ~_killed(cur, box_iou(blk, sboxes[:, hi:]) > thr)
        alive[:, lo:hi] = cur
    return alive[:, :N]


def select_top(key, alive, max_outputs):
    """The ``max_outputs`` largest keys, ties to the lowest index."""
    n = key.shape[-1]
    k = min(max_outputs, n)
    picked = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    valid = torch.gather(alive, -1, picked)
    idxs = torch.where(valid, picked, torch.zeros_like(picked))
    if k < max_outputs:
        fill = (*idxs.shape[:-1], max_outputs - k)
        idxs = torch.cat([idxs, idxs.new_zeros(fill)], dim=-1)
        valid = torch.cat([valid, valid.new_zeros(fill)], dim=-1)
    return idxs, valid


def nms(boxes, scores, thr, max_outputs):
    """Exact greedy NMS over [..., N]: (indices, valid), best first."""
    lead, N = scores.shape[:-1], scores.shape[-1]
    scores = scores.reshape(-1, N).float()
    boxes = boxes.reshape(-1, N, 4)
    order = torch.sort(-scores, dim=-1, stable=True)[1]
    sboxes = torch.gather(boxes.float(), 1, order[..., None].expand(-1, -1, 4))
    alive = alive_sorted(sboxes, torch.gather(scores, 1, order) > NEG_INF, thr)
    rank = torch.arange(N, device=scores.device, dtype=torch.float32)
    key = torch.where(alive, -rank, torch.full_like(rank, -float("inf")))
    picked, valid = select_top(key, alive, max_outputs)
    idxs = torch.where(valid, torch.gather(order, 1, picked),
                       torch.zeros_like(order[:, :1]))
    return (idxs.reshape(*lead, max_outputs),
            valid.reshape(*lead, max_outputs))


def grouped_nms_presorted(boxes, scores, thr, max_outputs):
    """NMS inside each group of [..., G, K] score-descending candidates,
    then the best ``max_outputs`` survivors over all groups."""
    lead, (G, K) = scores.shape[:-2], scores.shape[-2:]
    flat = scores.reshape(-1, G * K).float()
    alive = alive_sorted(boxes.reshape(-1, K, 4),
                         (scores > NEG_INF).reshape(-1, K), thr)
    alive = alive.reshape(-1, G * K)
    key = torch.where(alive, flat, torch.full_like(flat, -float("inf")))
    idxs, valid = select_top(key, alive, max_outputs)
    return (idxs.reshape(*lead, max_outputs),
            valid.reshape(*lead, max_outputs))


def batched_nms(boxes, scores, categories, thr, max_outputs):
    """Category-aware NMS by the coordinate offset of each category."""
    live = scores > NEG_INF
    max_coord = torch.where(live, boxes.max(dim=-1).values,
                            torch.zeros_like(scores)).amax(dim=-1, keepdim=True)
    offsets = categories.float() * (max_coord + 1.0)
    return nms(boxes + offsets[..., None], scores, thr, max_outputs)


# --------------------------------------------------------------- anchors
def cell_anchors(sizes, ratios) -> np.ndarray:
    sizes = np.asarray(sizes, np.float32)
    h_ratios = np.sqrt(np.asarray(ratios, np.float32))
    w_ratios = 1.0 / h_ratios
    ws = (w_ratios[:, None] * sizes[None, :]).reshape(-1)
    hs = (h_ratios[:, None] * sizes[None, :]).reshape(-1)
    return np.round(np.stack([-ws, -hs, ws, hs], axis=1) / 2.0).astype(
        np.float32)


@functools.lru_cache(maxsize=16)
def grid_anchors(feature_shapes: Tuple[Tuple[int, int], ...],
                 image_size: Tuple[int, int],
                 sizes: Tuple[Tuple[float, ...], ...],
                 ratios: Tuple[Tuple[float, ...], ...]):
    """Per-level anchors [H*W*A, 4], (y, x, anchor) fastest-last; the
    stride of a level is image_size // feature_size."""
    out = []
    for lvl, (fh, fw) in enumerate(feature_shapes):
        base = cell_anchors(sizes[lvl], ratios[lvl])
        sx = np.arange(fw, dtype=np.float32) * (image_size[1] // fw)
        sy = np.arange(fh, dtype=np.float32) * (image_size[0] // fh)
        yy, xx = np.meshgrid(sy, sx, indexing="ij")
        shifts = np.stack([xx, yy, xx, yy], axis=-1).reshape(-1, 1, 4)
        out.append((shifts + base[None]).reshape(-1, 4).astype(np.float32))
    return tuple(out)


# ------------------------------------------------------------------ blur
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


def blur(images, psfs, exact: bool):
    """images [B, C, H, W] (the whole canvas is the image) convolved with
    PSFs [B, 128, 128], each normalized to unit sum, as the reference's
    roll loop: reflect padding (63, 64) per axis, a circular convolution
    at the padded size (``exact``) or at the next 2/3/5-smooth size, whose
    wrap lands in the margin that is cropped away."""
    k = psfs.shape[-1]
    c = k // 2 - 1
    h, w = images.shape[-2:]
    psfs = psfs / psfs.sum(dim=(-2, -1), keepdim=True).clamp(min=1e-20)
    padded = F.pad(images, (c, k - c - 1, c, k - c - 1), mode="reflect")
    hp, wp = padded.shape[-2:]
    if not exact:
        fh, fw = _fast_fft_size(hp), _fast_fft_size(wp)
        padded = F.pad(padded, (0, fw - wp, 0, fh - hp), mode="replicate")
        hp, wp = fh, fw
    kern = psfs.new_zeros(psfs.shape[0], hp, wp)
    kern[:, :k, :k] = psfs
    kern = torch.roll(kern, shifts=(-c, -c), dims=(1, 2))
    out = torch.fft.irfft2(torch.fft.rfft2(padded.float())
                           * torch.fft.rfft2(kern.float())[:, None],
                           s=(hp, wp))
    return out[..., c:c + h, c:c + w]


# ---------------------------------------------------------------- resize
def resize_scale(h, w, min_size, max_size):
    h, w = np.float32(h), np.float32(w)
    return np.minimum(np.float32(min_size) / np.minimum(h, w),
                      np.float32(max_size) / np.maximum(h, w))


def bucket_hw(hw, scale, out_shape):
    """floor(size * scale), the scale shrunk so the image fits the bucket,
    in float32."""
    Ho, Wo = out_shape
    hf, wf = np.float32(hw[0]), np.float32(hw[1])
    scale = np.minimum(np.float32(scale),
                       np.minimum(np.float32(Ho) / hf, np.float32(Wo) / wf))
    return (min(int(np.floor(hf * scale)), Ho),
            min(int(np.floor(wf * scale)), Wo))


def model_bucket(hw, min_size, max_size, divisor: int = 64):
    """The model bucket of a batch: the largest resized extent over its
    valid sizes, rounded up to ``divisor``."""
    sizes = []
    for h, w in np.asarray(hw).reshape(-1, 2):
        scale = min(min_size / min(h, w), max_size / max(h, w))
        sizes.append((int(np.floor(h * scale)), int(np.floor(w * scale))))
    return (int(np.ceil(max(s[0] for s in sizes) / divisor) * divisor),
            int(np.ceil(max(s[1] for s in sizes) / divisor) * divisor))


def preprocess(images, hw, bucket, min_size, max_size):
    """Raw [B, H, W, 3] 0..1 images, valid sizes ``hw`` (host, [B, 2]) ->
    (normalized images resized bilinearly into the zero ``bucket``
    [B, Ho, Wo, 3], new valid sizes [B, 2] as a host array)."""
    B = images.shape[0]
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    out = images.new_zeros(B, *bucket, 3, dtype=torch.float32)
    new_hw = np.zeros((B, 2), np.int64)
    for b, (h, w) in enumerate(np.asarray(hw).reshape(-1, 2)):
        nh, nw = bucket_hw((h, w), resize_scale(h, w, min_size, max_size),
                           bucket)
        img = (images[b, :h, :w].float() - mean) / std
        out[b, :nh, :nw] = F.interpolate(
            img.permute(2, 0, 1)[None], size=(nh, nw), mode="bilinear",
            align_corners=False)[0].permute(1, 2, 0)
        new_hw[b] = nh, nw
    return out, new_hw


def resize_boxes(boxes, orig_hw, new_hw):
    """Boxes scaled by independent x and y ratios; hw [..., 2]."""
    ry = new_hw[..., 0:1].float() / orig_hw[..., 0:1].float()
    rx = new_hw[..., 1:2].float() / orig_hw[..., 1:2].float()
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1 * rx, y1 * ry, x2 * rx, y2 * ry], dim=-1)


# -------------------------------------------------------------- RoIAlign
def assign_levels(boxes):
    """torchvision's LevelMapper: [N, 4] -> 0..3 for P2..P5."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    area = w.clamp(min=0) * h.clamp(min=0)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224 + 1e-6))
    return (lvl.clamp(2, 5) - 2).long()


def _axis(coord, size):
    """torch roi_align's bilinear sampling along one axis: (low, high)
    indices and weights, the weights 0 where coord < -1 or > size."""
    in_range = (coord >= -1.0) & (coord <= size.to(coord.dtype))
    c = coord.clamp(min=0.0)
    low = torch.minimum(torch.floor(c).long(), size - 1)
    high = torch.minimum(low + 1, size - 1)
    frac = torch.where(low >= size - 1, torch.zeros_like(c), c - low.float())
    zero = torch.zeros_like(c)
    return (torch.stack([low, high], -1),
            torch.stack([torch.where(in_range, 1.0 - frac, zero),
                         torch.where(in_range, frac, zero)], -1))


def roi_samples(boxes, level_shapes, spatial_scale=None, output_size=7,
                sampling_ratio=2):
    """For [N, 4] boxes: (level [N], y (idx, w) [N, S, 2], x (idx, w)),
    S = output_size * sampling_ratio, with torch ``roi_align(aligned=
    False)``'s geometry: size clamped to >= 1, samples at bin centres of
    a g x g grid. Four levels map by ``assign_levels``; one level pools
    every box at ``spatial_scale``."""
    device = boxes.device
    boxes = boxes.float()
    if len(level_shapes) == 1:
        level = torch.zeros(boxes.shape[0], dtype=torch.long, device=device)
        scale = torch.full((boxes.shape[0],), float(spatial_scale),
                           device=device)
    else:
        level = assign_levels(boxes)
        scale = torch.tensor(LEVEL_SCALES, device=device)[level]
    sizes = torch.tensor([list(map(int, s)) for s in level_shapes],
                         device=device)
    Hl, Wl = sizes[level, 0], sizes[level, 1]
    x1, y1 = boxes[:, 0] * scale, boxes[:, 1] * scale
    roi_w = (boxes[:, 2] * scale - x1).clamp(min=1.0)
    roi_h = (boxes[:, 3] * scale - y1).clamp(min=1.0)
    s, g = output_size, sampling_ratio
    grid = (torch.arange(s, device=device, dtype=torch.float32)[:, None]
            + (torch.arange(g, device=device, dtype=torch.float32)[None]
               + 0.5) / g).reshape(-1)
    ys = y1[:, None] + grid[None] * (roi_h / s)[:, None]
    xs = x1[:, None] + grid[None] * (roi_w / s)[:, None]
    return level, _axis(ys, Hl[:, None]), _axis(xs, Wl[:, None])


def sample_rows(level, y, x, rois_per_image, sizes, first: int = 0):
    """Rows of each sample corner of rois ``first``.. in the levels
    concatenated as [sum_l B*H_l*W_l, C], and their bilinear weights, laid
    out [n, Sy, Sx, corner y, corner x]. ``sizes`` [(B, H_l, W_l)]."""
    device = level.device
    cells = torch.tensor([b * h * w for b, h, w in sizes], device=device)
    base = torch.cumsum(cells, 0) - cells
    hw = torch.tensor([h * w for _, h, w in sizes], device=device)
    W = torch.tensor([w for _, _, w in sizes], device=device)[level]
    img = (first + torch.arange(level.shape[0], device=device)
           ) // rois_per_image
    row0 = base[level] + img * hw[level]
    (yi, yw), (xi, xw) = y, x
    rows = (row0[:, None, None, None, None]
            + yi[:, :, None, :, None] * W[:, None, None, None, None]
            + xi[:, None, :, None, :])
    return rows, yw[:, :, None, :, None] * xw[:, None, :, None, :]


def roi_align(features: Sequence[torch.Tensor], boxes, spatial_scale=None,
              output_size: int = 7, sampling_ratio: int = 2,
              chunk: int = 256):
    """RoIAlign of [B, R, 4] boxes on NHWC levels (P2..P5, or one level at
    ``spatial_scale``) -> [B, R, s, s, C] in float32: each sample the
    bilinear blend of its 4 corners, each bin the mean of its g x g
    samples. Differentiable in the features (autograd scatters the
    cotangent back onto the same corners)."""
    B, R = boxes.shape[:2]
    C = features[0].shape[-1]
    s, g = output_size, sampling_ratio
    level, y, x = roi_samples(boxes.reshape(-1, 4),
                              [f.shape[1:3] for f in features],
                              spatial_scale, s, g)
    flat = torch.cat([f.reshape(-1, C) for f in features])
    sizes = [tuple(f.shape[:3]) for f in features]
    out = []
    for lo in range(0, B * R, chunk):
        hi = min(B * R, lo + chunk)
        rows, w = sample_rows(level[lo:hi],
                              tuple(t[lo:hi] for t in y),
                              tuple(t[lo:hi] for t in x), R, sizes, lo)
        vals = flat[rows.reshape(-1)].reshape(*rows.shape, C)
        samp = (vals * w[..., None]).sum(dim=(3, 4))
        out.append(samp.reshape(hi - lo, s, g, s, g, C).mean(dim=(2, 4)))
    return torch.cat(out).reshape(B, R, s, s, C)
