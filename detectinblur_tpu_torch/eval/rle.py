"""COCO run-length-encoded mask ops (the maskApi of cocoapi), in numpy.

Port of ``detectinblur_tpu/eval/rle.py``: the compressed-string codec
(``toString`` / ``frString``), ``encode``, ``decode``, ``area``,
``toBbox``, ``merge``, ``iou_matrix`` with crowd semantics, polygon
rasterization (``frPoly`` / ``frPolys``: even-odd filling at pixel
centres), ``masks_from_segmentation``, ``bbNms`` and ``rleNms``. Every
result is an integer count, or a ratio of two, equal to JAX's whether
JAX takes its g++ helper or its numpy path. The port has one path:
intersections are computed on the run lists (each mask's runs of ones as
sorted intervals), vectorised over every detection of an image at once.

RLE convention: column-major (Fortran) scan, counts alternate starting
with the number of zeros.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

RLE = Dict[str, object]  # {"size": [h, w], "counts": list[int] | bytes}


# ----------------------------------------------------------- codec
def _counts_list(rle: RLE) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, (bytes, str)):
        return frString(c)
    return np.asarray(c, dtype=np.int64)


def toString(counts: Sequence[int]) -> bytes:
    """COCO compressed RLE string: delta-coded signed varints, 5 bits per
    char, offset by 48."""
    out = bytearray()
    counts = list(map(int, counts))
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def frString(s: Union[bytes, str]) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, dtype=np.int64)


# ----------------------------------------------------------- encode/decode
def encode(mask: np.ndarray) -> RLE:
    """Encode a [H, W] binary mask (column-major runs)."""
    h, w = mask.shape
    flat = np.asarray(mask).reshape(-1, order="F").astype(bool)
    if flat.size == 0:
        return {"size": [h, w], "counts": [0]}
    changes = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], changes, [flat.size]]))
    if flat[0]:
        runs = np.concatenate([[0], runs])
    return {"size": [h, w], "counts": runs.tolist()}


def decode(rle: RLE) -> np.ndarray:
    h, w = rle["size"]
    counts = _counts_list(rle)
    vals = np.repeat((np.arange(len(counts)) % 2).astype(np.uint8), counts)
    return vals.reshape((h, w), order="F")


def area(rle: RLE) -> int:
    return int(_counts_list(rle)[1::2].sum())


def toBbox(rle: RLE) -> np.ndarray:
    """[x, y, w, h] of the mask's pixels, zeros for an empty mask."""
    ys, xs = np.nonzero(decode(rle))
    if len(xs) == 0:
        return np.zeros(4)
    return np.array([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                     ys.max() - ys.min() + 1], np.float64)


def merge(rles: Sequence[RLE], intersect: bool = False) -> RLE:
    if not rles:
        return {"size": [0, 0], "counts": [0]}
    m = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        other = decode(r).astype(bool)
        m = (m & other) if intersect else (m | other)
    return encode(m)


# ----------------------------------------------------------- iou
def _ones(rle: RLE):
    """The mask's runs of ones as sorted, disjoint [start, end) offsets
    into the column-major scan, empty runs dropped."""
    ends = np.cumsum(_counts_list(rle))
    starts, stops = ends[0:-1:2], ends[1::2]
    keep = stops > starts
    return starts[keep], stops[keep]


def _covered(starts, stops, x):
    """How many of the pixels before each offset ``x`` the runs
    ``[starts, stops)`` cover."""
    # A run of no length at offset -1 stands before every run, so each x
    # finds the last run that starts at or before it.
    s = np.concatenate([[-1], starts])
    n = np.concatenate([[0], stops - starts])
    before = np.concatenate([[0], np.cumsum(n)[:-1]])
    i = np.searchsorted(s, x, side="right") - 1
    return before[i] + np.clip(x - s[i], 0, n[i])


def iou_matrix(dts: Sequence[RLE], gts: Sequence[RLE], iscrowd) -> np.ndarray:
    """[D, G] IoU of each detection mask with each GT mask; against a
    crowd GT the denominator is the detection's area (IoA)."""
    out = np.zeros((len(dts), len(gts)))
    if not len(dts) or not len(gts):
        return out
    runs = [_ones(d) for d in dts]
    d_area = np.array([int((e - s).sum()) for s, e in runs], np.int64)
    owner = np.repeat(np.arange(len(dts)), [len(s) for s, _ in runs])
    d_starts = np.concatenate([s for s, _ in runs])
    d_stops = np.concatenate([e for _, e in runs])
    for j, g in enumerate(gts):
        gs, ge = _ones(g)
        g_area = int((ge - gs).sum())
        per_run = _covered(gs, ge, d_stops) - _covered(gs, ge, d_starts)
        inter = np.zeros(len(dts), np.int64)
        np.add.at(inter, owner, per_run)
        # Integers below 2**53 convert to float64 exactly, so each ratio
        # is the correctly rounded quotient JAX's Python or C++ path gives.
        denom = d_area if iscrowd[j] else d_area + g_area - inter
        out[:, j] = np.where(denom > 0, inter / np.maximum(denom, 1), 0.0)
    return out


# ----------------------------------------------------------- polygons
def frPoly(poly: Sequence[float], h: int, w: int) -> RLE:
    """Rasterize one polygon [x0, y0, x1, y1, ...] into an RLE by even-odd
    filling at pixel centres (cocoapi's rleFrPoly)."""
    xs = np.asarray(poly[0::2], np.float64)
    ys = np.asarray(poly[1::2], np.float64)
    mask = np.zeros((h, w), np.uint8)
    if len(xs) < 3:
        return encode(mask)
    px = np.arange(w) + 0.5
    x1, y1 = xs, ys
    x2, y2 = np.roll(xs, -1), np.roll(ys, -1)
    for row in range(h):
        cy = row + 0.5
        cond = (y1 <= cy) != (y2 <= cy)
        if not cond.any():
            continue
        xi = x1[cond] + (cy - y1[cond]) * (x2[cond] - x1[cond]) / (y2[cond] - y1[cond])
        mask[row] = (xi[None, :] > px[:, None]).sum(axis=1) % 2 == 1
    return encode(mask)


def frPolys(polys: Sequence[Sequence[float]], h: int, w: int) -> RLE:
    """Union of several polygon parts (COCO multi-part segmentation)."""
    return merge([frPoly(p, h, w) for p in polys])


def to_rle(segm, h: int, w: int) -> RLE:
    """A COCO segmentation field as an RLE: polygons rasterized on the
    image's [h, w] canvas, an RLE as it is (pycocotools' annToRLE)."""
    if isinstance(segm, list):
        return frPolys(segm, h, w)
    if isinstance(segm, dict):
        return segm
    raise TypeError(type(segm))


def masks_from_segmentation(segm, h: int, w: int) -> np.ndarray:
    """GT mask from a COCO segmentation field (polygons or RLE)."""
    return decode(to_rle(segm, h, w))


# ----------------------------------------------------------- nms
def bbNms(boxes: np.ndarray, thr: float) -> np.ndarray:
    """Greedy NMS over xywh boxes (maskApi.h bbNms). Returns keep mask."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    n = len(boxes)
    keep = np.ones(n, bool)
    x1, y1 = boxes[:, 0], boxes[:, 1]
    x2, y2 = boxes[:, 0] + boxes[:, 2], boxes[:, 1] + boxes[:, 3]
    areas = boxes[:, 2] * boxes[:, 3]
    for i in range(n):
        if not keep[i]:
            continue
        for j in range(i + 1, n):
            if not keep[j]:
                continue
            iw = min(x2[i], x2[j]) - max(x1[i], x1[j])
            ih = min(y2[i], y2[j]) - max(y1[i], y1[j])
            if iw <= 0 or ih <= 0:
                continue
            inter = iw * ih
            union = areas[i] + areas[j] - inter
            if union > 0 and inter / union > thr:
                keep[j] = False
    return keep


def rleNms(rles: Sequence[RLE], thr: float) -> np.ndarray:
    """Greedy NMS over RLE masks (maskApi.h rleNms). Returns keep mask."""
    n = len(rles)
    keep = np.ones(n, bool)
    if n == 0:
        return keep
    ious = iou_matrix(rles, rles, np.zeros(n, bool))
    for i in range(n):
        if not keep[i]:
            continue
        for j in range(i + 1, n):
            if keep[j] and ious[j, i] > thr:
                keep[j] = False
    return keep
