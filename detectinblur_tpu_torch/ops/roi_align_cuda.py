"""Wrapper of the CUDA RoIAlign forward kernel (``csrc/roi_align_fwd.cu``).

``multiscale_roi_align_cuda`` computes the shared sample geometry in torch
(``ops/roi_align.py::roi_geometry``), then ``roi_align_fwd`` launches the
kernel on PyTorch's current stream. For tensors on the CPU both run the
plain torch version; for CUDA tensors they launch the kernel or raise,
never fall back.

``roi_align_fwd.launches`` counts kernel launches, so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from detectinblur_tpu_torch.ops.roi_align import (
    RoIGeometry,
    multiscale_roi_align,
    roi_align_from_geometry,
    roi_geometry,
)
from detectinblur_tpu_torch.utils import cuda_build

LIBRARY = "roi_align_fwd"
OUTPUT_SIZE = 7
SAMPLING_RATIO = 2
_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}   # code, vector


def _kernel():
    lib = cuda_build.load(LIBRARY)
    fn = lib.roi_align_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(features: Sequence[torch.Tensor], boxes: torch.Tensor) -> None:
    if len(features) != 4:
        raise ValueError(f"expected 4 FPN levels, got {len(features)}")
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


def roi_align_fwd(features: Sequence[torch.Tensor], geom: RoIGeometry,
                  rois_per_image: int) -> torch.Tensor:
    """The kernel alone: pool N rois [N, 7, 7, C] from ``geom``, which must
    come from ``roi_geometry`` on these levels' shapes (it clamps every
    index into its level). For tensors on the CPU, the plain
    ``roi_align_from_geometry``."""
    if geom.level.device.type == "cpu":
        return roi_align_from_geometry(features, geom, rois_per_image,
                                       OUTPUT_SIZE)
    N, C = geom.level.shape[0], features[0].shape[-1]
    S = OUTPUT_SIZE * SAMPLING_RATIO
    for t, dt in zip(geom, (torch.int32, torch.int32, torch.float32,
                            torch.int32, torch.float32)):
        if t.device != features[0].device or t.dtype != dt:
            raise ValueError("geometry must be roi_geometry's, on the "
                             "features' device")
    if any(t.shape != (N, S, 2) for t in geom[1:]):
        raise ValueError(f"geometry tables must be [{N}, {S}, 2]")
    if N != features[0].shape[0] * rois_per_image:
        raise ValueError(f"{N} rois is not {features[0].shape[0]} images x "
                         f"{rois_per_image}")
    geom = RoIGeometry(*(t.contiguous() for t in geom))
    out = torch.empty(N, OUTPUT_SIZE, OUTPUT_SIZE, C,
                      dtype=features[0].dtype, device=features[0].device)
    dims = [int(d) for f in features for d in f.shape[1:3]]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
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


roi_align_fwd.launches = 0


def multiscale_roi_align_cuda(features: Sequence[torch.Tensor],
                              boxes: torch.Tensor) -> torch.Tensor:
    """FPN RoIAlign over P2..P5 (7x7 bins, 2x2 samples):
    ``features`` 4 levels NHWC [B, H_l, W_l, C] (float32 or bfloat16),
    ``boxes`` [B, R, 4] -> [B, R, 7, 7, C] in the features' dtype.
    Geometry in torch, then the kernel (``roi_align_fwd``)."""
    if boxes.device.type == "cpu":
        return multiscale_roi_align(features, boxes, OUTPUT_SIZE,
                                    SAMPLING_RATIO)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    _check(features, boxes)
    B, R = boxes.shape[:2]
    geom = roi_geometry(boxes.reshape(B * R, 4),
                        [f.shape[1:3] for f in features],
                        OUTPUT_SIZE, SAMPLING_RATIO)
    out = roi_align_fwd(features, geom, R)
    return out.reshape(B, R, OUTPUT_SIZE, OUTPUT_SIZE, -1)
