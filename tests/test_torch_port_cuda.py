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
from detectinblur_tpu_torch.ops.roi_align import (
    multiscale_roi_align,
    roi_align_backward_from_geometry,
    roi_geometry,
)

SHAPES = ((64, 80), (32, 40), (16, 20), (8, 10))

# Sliver, giant, sub-pixel and edge rois, a zeroed invalid slot and a box
# past the image edge.
EDGE_ROIS = np.array([[0, 0, 250, 310], [10, 10, 60, 60], [5, 5, 1200, 1200],
                      [30, 40, 100, 90], [100, 0, 118, 250],
                      [0, 120, 310, 140], [50, 50, 51, 51],
                      [200, 5, 206, 230], [0, 0, 0, 0],
                      [290, 230, 400, 330]], np.float32)

# Rois that stress the kernels' separable form: a tall sliver whose 14
# samples reach 28 distinct rows, footprints larger than any fixed window
# (the whole image, a full-width sliver), a border roi whose samples have
# low == high, and 40 one-pixel rois stacked on one cell (atomic contention).
STRESS_ROIS = np.array([[100, 2, 104, 252], [0, 0, 319, 255],
                        [0, 100, 320, 104], [310, 250, 322, 258]]
                       + [[50, 50, 51, 51]] * 40, np.float32)


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
    special = np.concatenate([EDGE_ROIS, STRESS_ROIS])
    n = min(R, len(special))
    b[:, :n] = special[:n]
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


def _dout(rng, B, R, C, cuda, dt):
    d = rng.standard_normal((B * R, 7, 7, C), dtype=np.float32)
    d[::7] = 0.0    # rois with an all-zero cotangent: unsampled slots
    return torch.from_numpy(d).to(cuda, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_bwd_kernel_matches_plain(rng, cuda, dtype):
    """The kernel's float32 sums against the plain index_add_ backward on
    the same cotangent (read in its dtype) and geometry: within 1e-5 of the
    largest gradient. Both form the same products; only the order of the
    float32 sums differs, and atomics change it from run to run."""
    dt = getattr(torch, dtype)
    _, boxes = _inputs(rng)
    B, R = boxes.shape[:2]
    geom = roi_geometry(torch.from_numpy(boxes).reshape(-1, 4).to(cuda),
                        SHAPES)
    dout = _dout(rng, B, R, 256, cuda, dt)
    before = roi_align_cuda.roi_align_bwd.launches
    got = roi_align_cuda.roi_align_bwd(dout, geom, R, SHAPES)
    torch.cuda.synchronize()
    assert roi_align_cuda.roi_align_bwd.launches == before + 1
    ref = roi_align_backward_from_geometry(dout, geom, R, SHAPES)
    for g, r, (h, w) in zip(got, ref, SHAPES):
        assert g.dtype == torch.float32 and g.shape == (B, h, w, 256)
        scale = r.abs().max().item()
        assert scale > 0
        assert (g - r).abs().max().item() <= 1e-5 * scale


@pytest.mark.gpu
def test_autograd_function_gradient_card_vs_cpu(rng, cuda):
    """The features' gradient through multiscale_roi_align_cuda on the card
    (both kernels) against the CPU's (both plain versions): float32,
    within 1e-5 of the largest gradient."""
    feats, boxes = _inputs(rng)
    w = rng.standard_normal((2, 300, 7, 7, 256), dtype=np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        fs = [torch.from_numpy(f).to(dev).requires_grad_() for f in feats]
        before = (roi_align_cuda.roi_align_fwd.launches,
                  roi_align_cuda.roi_align_bwd.launches)
        out = roi_align_cuda.multiscale_roi_align_cuda(
            fs, torch.from_numpy(boxes).to(dev))
        (out * torch.from_numpy(w).to(dev)).sum().backward()
        launched = (roi_align_cuda.roi_align_fwd.launches - before[0],
                    roi_align_cuda.roi_align_bwd.launches - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (1, 1))
        grads[str(dev)] = [f.grad.cpu() for f in fs]
    for g, r in zip(grads["cuda"], grads["cpu"]):
        assert (g - r).abs().max().item() <= 1e-5 * r.abs().max().item()


@pytest.mark.gpu
def test_roi_align_bwd_kernel_rejects_bad_inputs(rng, cuda):
    _, boxes = _inputs(rng, R=4)
    geom = roi_geometry(torch.from_numpy(boxes).reshape(-1, 4).to(cuda),
                        SHAPES)
    with pytest.raises(ValueError):   # not a whole 16-byte f32 vector
        roi_align_cuda.roi_align_bwd(_dout(rng, 2, 4, 6, cuda, torch.float32),
                                     geom, 4, SHAPES)
    with pytest.raises(TypeError):
        roi_align_cuda.roi_align_bwd(_dout(rng, 2, 4, 16, cuda, torch.half),
                                     geom, 4, SHAPES)
    strided = _dout(rng, 2, 4, 32, cuda, torch.float32)[..., ::2]
    with pytest.raises(ValueError):
        roi_align_cuda.roi_align_bwd(strided, geom, 4, SHAPES)
    with pytest.raises(ValueError):   # 8 rois are not whole images of 3
        roi_align_cuda.roi_align_bwd(_dout(rng, 2, 4, 16, cuda, torch.float32),
                                     geom, 3, SHAPES)


def test_stress_rois_reach_the_separable_limits():
    """The stress rois do what they are there for (no card needed): the
    sliver's samples reach 28 distinct rows, the whole-image roi covers
    every row and column of its level, the border roi has samples with
    low == high, and the stacked rois share one cell."""
    geom = roi_geometry(torch.from_numpy(STRESS_ROIS), SHAPES)

    def unique(idx, w, n):
        return len(torch.unique(idx[n][w[n] != 0]))

    assert unique(geom.y_idx, geom.y_w, 0) == 28
    h, w = SHAPES[int(geom.level[1])]
    assert (unique(geom.y_idx, geom.y_w, 1), unique(geom.x_idx, geom.x_w, 1)) == (h, w)
    assert bool(((geom.y_idx[3, :, 0] == geom.y_idx[3, :, 1])
                 & (geom.y_w[3, :, 0] != 0)).any())
    stacked = torch.stack([geom.y_idx[4:], geom.x_idx[4:]])
    assert bool((stacked == stacked[:, :1]).all())
