"""Wrappers of the CUDA RoIAlign kernels (``csrc/roi_align_fwd.cu``,
``csrc/roi_align_bwd.cu``) and the autograd Function over them.

``multiscale_roi_align_cuda`` (P2..P5) and ``roi_align_single_level_cuda``
(a single-map detector's one level) are differentiable in the features:
the forward computes the shared sample geometry in torch
(``ops/roi_align.py::roi_geometry``) once, launches ``roi_align_fwd`` and
keeps the geometry table for the backward, which launches
``roi_align_bwd`` on the same table (a second ``log2`` could move a roi
across a level boundary). Boxes get no gradient, as in torchvision; the
JAX VJP gives them zeros. For tensors on the CPU the wrappers run the plain
torch versions; for CUDA tensors they launch the kernel or raise, never
fall back.

The kernels take four level slots and read, for each roi, only the slot
of its ``level`` entry. One level goes in slot 0 and is repeated in the
other three; its geometry puts every roi on level 0, so the kernels run
unchanged on it.

``roi_align_fwd.launches`` and ``roi_align_bwd.launches`` count kernel
launches, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from detectinblur_tpu_torch.ops.roi_align import (
    RoIGeometry,
    roi_align_backward_from_geometry,
    roi_align_from_geometry,
    roi_geometry,
)
from detectinblur_tpu_torch.utils import cuda_build
from detectinblur_tpu_torch.utils.profiling import counts_launches

OUTPUT_SIZE = 7
SAMPLING_RATIO = 2
_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}   # code, vector


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """The C entry ``name`` of ``csrc/<name>.cu``. Forward and backward
    share one signature: dtype, 4 level pointers, 4 (H, W) pairs, 5
    geometry pointers, the output (forward) or cotangent (backward)
    pointer, 3 sizes, the stream."""
    fn = getattr(cuda_build.load(name), name)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _slots(levels: Sequence) -> list:
    """The kernels' four level slots: 4 levels, or one level repeated."""
    if len(levels) not in (1, 4):
        raise ValueError(f"expected 4 FPN levels or one level, got "
                         f"{len(levels)}")
    return list(levels) * (4 // len(levels))


def _check(features: Sequence[torch.Tensor], boxes: torch.Tensor) -> None:
    _slots(features)
    f0 = features[0]
    if f0.dtype not in _DTYPES:
        raise TypeError(f"features must be float32 or bfloat16, got {f0.dtype}")
    B, C = f0.shape[0], f0.shape[-1]
    vec = _DTYPES[f0.dtype][1]
    if C % vec:
        raise ValueError(f"channels ({C}) must be a multiple of {vec}")
    for f in features:
        if f.device != boxes.device or f.dtype != f0.dtype:
            raise ValueError("all levels must share the boxes' device and "
                             "one dtype")
        if f.ndim != 4 or f.shape[0] != B or f.shape[-1] != C:
            raise ValueError(f"levels must be NHWC [B, H, W, {C}], got "
                             f"{tuple(f.shape)}")
        if not f.is_contiguous() or f.data_ptr() % 16:
            raise ValueError("levels must be contiguous and 16-byte aligned")
    if boxes.ndim != 3 or boxes.shape[0] != B or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [B={B}, R, 4], got "
                         f"{tuple(boxes.shape)}")


def _check_geometry(geom: RoIGeometry, n_rois: int, device) -> RoIGeometry:
    S = OUTPUT_SIZE * SAMPLING_RATIO
    for t, dt in zip(geom, (torch.int32, torch.int32, torch.float32,
                            torch.int32, torch.float32)):
        if t.device != device or t.dtype != dt:
            raise ValueError("geometry must be roi_geometry's, on the "
                             "kernel's device")
    if geom.level.shape != (n_rois,) or any(
            t.shape != (n_rois, S, 2) for t in geom[1:]):
        raise ValueError(f"geometry tables must be [{n_rois}, {S}, 2]")
    return RoIGeometry(*(t.contiguous() for t in geom))


@counts_launches
def roi_align_fwd(features: Sequence[torch.Tensor], geom: RoIGeometry,
                  rois_per_image: int) -> torch.Tensor:
    """The kernel alone: pool N rois [N, 7, 7, C] from ``geom``, which must
    come from ``roi_geometry`` on these levels' shapes (it clamps every
    index into its level, and puts every roi on level 0 of one level).
    For tensors on the CPU, the plain ``roi_align_from_geometry``."""
    if geom.level.device.type == "cpu":
        return roi_align_from_geometry(features, geom, rois_per_image,
                                       OUTPUT_SIZE)
    features = _slots(features)
    N, C = geom.level.shape[0], features[0].shape[-1]
    geom = _check_geometry(geom, N, features[0].device)
    if N != features[0].shape[0] * rois_per_image:
        raise ValueError(f"{N} rois is not {features[0].shape[0]} images x "
                         f"{rois_per_image}")
    out = torch.empty(N, OUTPUT_SIZE, OUTPUT_SIZE, C,
                      dtype=features[0].dtype, device=features[0].device)
    dims = [int(d) for f in features for d in f.shape[1:3]]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel("roi_align_fwd")(
            _DTYPES[features[0].dtype][0],
            *(f.data_ptr() for f in features), *dims,
            geom.level.data_ptr(), geom.y_idx.data_ptr(),
            geom.y_w.data_ptr(), geom.x_idx.data_ptr(), geom.x_w.data_ptr(),
            out.data_ptr(), N, rois_per_image, C, stream)
    if err:
        raise RuntimeError(f"roi_align_fwd kernel launch failed: CUDA error "
                           f"{err}")
    roi_align_fwd.launches += 1
    return out


@counts_launches
def roi_align_bwd(dout: torch.Tensor, geom: RoIGeometry, rois_per_image: int,
                  level_shapes: Sequence[Sequence[int]],
                  out_dtype: torch.dtype = torch.float32):
    """The backward kernel alone: the cotangent ``dout`` [N, 7, 7, C]
    (float32 or bfloat16) of ``roi_align_fwd`` on ``geom`` -> one gradient
    [B, H_l, W_l, C] per level of ``level_shapes`` (4, or 1),
    accumulated in float32 and returned in ``out_dtype`` (one cast of the
    float32 sums). For tensors on the CPU, the plain
    ``roi_align_backward_from_geometry``."""
    if dout.device.type == "cpu":
        grads = roi_align_backward_from_geometry(dout, geom, rois_per_image,
                                                 level_shapes)
        return [g.to(out_dtype) for g in grads]
    if dout.dtype not in _DTYPES:
        raise TypeError(f"cotangent must be float32 or bfloat16, got "
                        f"{dout.dtype}")
    N, C = dout.shape[0], dout.shape[-1]
    if dout.shape[1:3] != (OUTPUT_SIZE, OUTPUT_SIZE) or dout.ndim != 4:
        raise ValueError(f"cotangent must be [N, 7, 7, C], got "
                         f"{tuple(dout.shape)}")
    if C % _DTYPES[dout.dtype][1]:
        raise ValueError(f"channels ({C}) must be a multiple of "
                         f"{_DTYPES[dout.dtype][1]}")
    if not dout.is_contiguous() or dout.data_ptr() % 16:
        raise ValueError("cotangent must be contiguous and 16-byte aligned")
    if len(level_shapes) not in (1, 4) or N % rois_per_image:
        raise ValueError(f"expected 4 levels or one, and a whole number of "
                         f"images of {rois_per_image} rois, got "
                         f"{len(level_shapes)} levels and {N} rois")
    geom = _check_geometry(geom, N, dout.device)
    B = N // rois_per_image
    sizes = [B * int(h) * int(w) * C for h, w in level_shapes]
    # One zero-filled float32 buffer holds the levels (one memset).
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=dout.device)
    grads = [g.view(B, int(h), int(w), C) for g, (h, w) in zip(
        torch.split(flat, sizes), level_shapes)]
    dims = [int(d) for hw in _slots(level_shapes) for d in hw]
    with torch.cuda.device(dout.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel("roi_align_bwd")(
            _DTYPES[dout.dtype][0], *(g.data_ptr() for g in _slots(grads)),
            *dims,
            geom.level.data_ptr(), geom.y_idx.data_ptr(),
            geom.y_w.data_ptr(), geom.x_idx.data_ptr(), geom.x_w.data_ptr(),
            dout.data_ptr(), N, rois_per_image, C, stream)
    if err:
        raise RuntimeError(f"roi_align_bwd kernel launch failed: CUDA error "
                           f"{err}")
    roi_align_bwd.launches += 1
    if out_dtype == torch.float32:
        return grads
    return [g.view(B, int(h), int(w), C) for g, (h, w) in zip(
        torch.split(flat.to(out_dtype), sizes), level_shapes)]


class _RoIAlign(torch.autograd.Function):
    """RoIAlign over P2..P5 (``spatial_scale`` None) or over one level at
    ``spatial_scale``, differentiable in the levels (not in the boxes)."""

    @staticmethod
    def forward(ctx, boxes, spatial_scale, *features):
        B, R = boxes.shape[:2]
        shapes = [tuple(f.shape[1:3]) for f in features]
        geom = roi_geometry(boxes.reshape(B * R, 4), shapes, OUTPUT_SIZE,
                            SAMPLING_RATIO, spatial_scale)
        out = roi_align_fwd(features, geom, R)
        ctx.save_for_backward(*geom)
        ctx.level_shapes = shapes
        ctx.feature_dtype = features[0].dtype
        return out.reshape(B, R, OUTPUT_SIZE, OUTPUT_SIZE, -1)

    @staticmethod
    def backward(ctx, dout):
        B, R = dout.shape[:2]
        grads = roi_align_bwd(
            dout.reshape(B * R, OUTPUT_SIZE, OUTPUT_SIZE, -1).contiguous(),
            RoIGeometry(*ctx.saved_tensors), R, ctx.level_shapes,
            ctx.feature_dtype)
        return (None, None, *grads)


def _apply(features: Sequence[torch.Tensor], boxes: torch.Tensor,
           spatial_scale) -> torch.Tensor:
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {boxes.device}")
    if boxes.device.type == "cuda":
        _check(features, boxes)
    return _RoIAlign.apply(boxes.detach(), spatial_scale, *features)


def multiscale_roi_align_cuda(features: Sequence[torch.Tensor],
                              boxes: torch.Tensor) -> torch.Tensor:
    """FPN RoIAlign over P2..P5 (7x7 bins, 2x2 samples):
    ``features`` 4 levels NHWC [B, H_l, W_l, C] (float32 or bfloat16),
    ``boxes`` [B, R, 4] -> [B, R, 7, 7, C] in the features' dtype.
    Geometry in torch, then the kernels (``roi_align_fwd``, and
    ``roi_align_bwd`` for the features' gradient)."""
    if len(features) != 4:
        raise ValueError(f"expected 4 FPN levels, got {len(features)}")
    return _apply(features, boxes, None)


def roi_align_single_level_cuda(feature: torch.Tensor, boxes: torch.Tensor,
                                spatial_scale: float) -> torch.Tensor:
    """Single-level RoIAlign (7x7 bins, 2x2 samples), JAX
    ``roi_align_single_level`` batched: ``feature`` NHWC [B, H, W, C]
    (float32 or bfloat16), ``boxes`` [B, R, 4] pooled at ``spatial_scale``
    -> [B, R, 7, 7, C] in the feature's dtype, through the same kernels
    as ``multiscale_roi_align_cuda``."""
    return _apply([feature], boxes, float(spatial_scale))
