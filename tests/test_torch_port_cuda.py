"""The port's CUDA kernels against their plain torch versions, on a card.

These tests import neither JAX nor the JAX package, so they run on the
GPU machine, which has no JAX:

    python -m pytest tests/test_torch_port_cuda.py -q

Without a CUDA card they skip with a reason.
"""

import numpy as np
import pytest
import torch

from detectinblur_tpu_torch.ops import roi_align_cuda
from detectinblur_tpu_torch.ops.roi_align import multiscale_roi_align

# Sliver, giant, sub-pixel and edge rois, a zeroed invalid slot and a box
# past the image edge.
EDGE_ROIS = np.array([[0, 0, 250, 310], [10, 10, 60, 60], [5, 5, 1200, 1200],
                      [30, 40, 100, 90], [100, 0, 118, 250],
                      [0, 120, 310, 140], [50, 50, 51, 51],
                      [200, 5, 206, 230], [0, 0, 0, 0],
                      [290, 230, 400, 330]], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(rng, B=2, R=300, C=256):
    feats = [rng.standard_normal((B, h, w, C), dtype=np.float32)
             for h, w in ((64, 80), (32, 40), (16, 20), (8, 10))]
    b = np.zeros((B, R, 4), np.float32)
    b[..., 0] = rng.uniform(-10, 300, (B, R))
    b[..., 1] = rng.uniform(-10, 240, (B, R))
    b[..., 2] = b[..., 0] + rng.uniform(0.5, 200, (B, R))
    b[..., 3] = b[..., 1] + rng.uniform(0.5, 200, (B, R))
    n = min(R, len(EDGE_ROIS))
    b[:, :n] = EDGE_ROIS[:n]
    return feats, b


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_kernel_matches_plain(rng, cuda, dtype):
    """f32: within 1e-5 of the output's max magnitude (the same samples and
    weights, sums reassociated; no TF32 anywhere). bf16: both round one
    f32 sum to bf16, and reassociation can flip that rounding by one bf16
    ulp, 2^-7 relative."""
    dt = getattr(torch, dtype)
    feats, boxes = _inputs(rng)
    feats = [torch.from_numpy(f).to(cuda, dt) for f in feats]
    boxes = torch.from_numpy(boxes).to(cuda)
    before = roi_align_cuda.roi_align_fwd.launches
    out = roi_align_cuda.multiscale_roi_align_cuda(feats, boxes)
    torch.cuda.synchronize()
    assert roi_align_cuda.roi_align_fwd.launches == before + 1
    assert out.dtype == dt and out.shape == (2, 300, 7, 7, 256)
    ref = multiscale_roi_align(feats, boxes).float()
    scale = ref.abs().max().item()
    err = (out.float() - ref).abs()
    if dt == torch.float32:
        assert err.max().item() <= 1e-5 * scale
    else:
        bound = 2 ** -7 * torch.maximum(out.float().abs(), ref.abs()) + 1e-5 * scale
        assert bool((err <= bound).all())


@pytest.mark.gpu
def test_roi_align_kernel_rejects_bad_inputs(rng, cuda):
    feats, boxes = _inputs(rng, R=4, C=6)   # not a whole 16-byte f32 vector
    feats = [torch.from_numpy(f).to(cuda) for f in feats]
    with pytest.raises(ValueError):
        roi_align_cuda.multiscale_roi_align_cuda(
            feats, torch.from_numpy(boxes).to(cuda))
    feats, boxes = _inputs(rng, R=4, C=16)
    feats = [torch.from_numpy(f).to(cuda).half() for f in feats]
    with pytest.raises(TypeError):
        roi_align_cuda.multiscale_roi_align_cuda(
            feats, torch.from_numpy(boxes).to(cuda))
