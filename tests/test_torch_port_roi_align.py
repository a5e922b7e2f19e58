"""The port's RoIAlign (shared geometry + plain torch version + CUDA
wrapper) held against the JAX XLA path and the Pallas kernel run in
interpret mode (the kernel itself is held on the card by
test_torch_port_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from detectinblur_tpu.ops.roi_align import _assign_levels
from detectinblur_tpu.ops.roi_align import multiscale_roi_align as jax_roi_align
from detectinblur_tpu.ops.roi_align_pallas import pallas_multiscale_roi_align
from detectinblur_tpu_torch.ops import roi_align_cuda
from detectinblur_tpu_torch.ops.roi_align import (
    assign_levels,
    multiscale_roi_align,
)

# Sliver, giant, sub-pixel and edge rois (tests/test_roi_align_pallas.py:51-58)
# plus a zeroed invalid slot and a box past the image edge.
EDGE_ROIS = np.array([[0, 0, 250, 310], [10, 10, 60, 60], [5, 5, 1200, 1200],
                      [30, 40, 100, 90], [100, 0, 118, 250],
                      [0, 120, 310, 140], [50, 50, 51, 51],
                      [200, 5, 206, 230], [0, 0, 0, 0],
                      [290, 230, 400, 330]], np.float32)


def _feats(rng, B, C=8):
    return [rng.random((B, h, w, C), dtype=np.float32)
            for h, w in ((64, 80), (32, 40), (16, 20), (8, 10))]


def _boxes(rng, B, R):
    b = np.zeros((B, R, 4), np.float32)
    b[..., 0] = rng.uniform(-10, 300, (B, R))
    b[..., 1] = rng.uniform(-10, 240, (B, R))
    b[..., 2] = b[..., 0] + rng.uniform(0.5, 200, (B, R))
    b[..., 3] = b[..., 1] + rng.uniform(0.5, 200, (B, R))
    b[:, :len(EDGE_ROIS)] = EDGE_ROIS
    return b


def _jax_expected(feats, boxes):
    return np.stack([
        np.asarray(jax_roi_align(tuple(f[b] for f in feats), boxes[b]))
        for b in range(boxes.shape[0])])


def test_levels_match_jax(rng):
    b = _boxes(rng, 1, 200)[0]
    np.testing.assert_array_equal(assign_levels(torch.from_numpy(b)).numpy(),
                                  np.asarray(_assign_levels(b, 224, 4)))


def test_plain_matches_jax_xla(rng):
    """Same geometry, float32 sums in another order: 2e-5 abs on [0, 1)
    features (the JAX package holds its own kernels to the same)."""
    feats, boxes = _feats(rng, 2), _boxes(rng, 2, 40)
    ours = multiscale_roi_align([torch.from_numpy(f) for f in feats],
                                torch.from_numpy(boxes))
    assert ours.shape == (2, 40, 7, 7, 8)
    np.testing.assert_allclose(ours.numpy(), _jax_expected(feats, boxes),
                               atol=2e-5)


def test_plain_matches_jax_pallas_interpret(rng):
    """Against the TPU kernel itself, interpreted on the CPU."""
    feats, boxes = _feats(rng, 1), _boxes(rng, 1, 16)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_multiscale_roi_align(
            [jnp.asarray(f) for f in feats], jnp.asarray(boxes)))
    ours = multiscale_roi_align([torch.from_numpy(f) for f in feats],
                                torch.from_numpy(boxes))
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)


def test_plain_bf16_rounds_the_f32_result(rng):
    """bf16 features are summed in float32 and rounded once: equal to the
    f32 result on the same (bf16-representable) inputs up to one bf16
    rounding, 2^-8 relative."""
    feats, boxes = _feats(rng, 1), _boxes(rng, 1, 20)
    f16 = [torch.from_numpy(f).bfloat16() for f in feats]
    out16 = multiscale_roi_align(f16, torch.from_numpy(boxes))
    out32 = multiscale_roi_align([f.float() for f in f16],
                                 torch.from_numpy(boxes))
    assert out16.dtype == torch.bfloat16
    torch.testing.assert_close(out16.float(), out32, rtol=2 ** -8, atol=1e-6)


def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing(rng):
    feats, boxes = _feats(rng, 2), _boxes(rng, 2, 12)
    tf = [torch.from_numpy(f) for f in feats]
    before = roi_align_cuda.roi_align_fwd.launches
    out = roi_align_cuda.multiscale_roi_align_cuda(tf, torch.from_numpy(boxes))
    assert roi_align_cuda.roi_align_fwd.launches == before
    torch.testing.assert_close(out, multiscale_roi_align(
        tf, torch.from_numpy(boxes)), rtol=0, atol=0)


def test_wrapper_rejects_other_devices(rng):
    feats = [torch.empty(1, 4, 4, 8, device="meta")] * 4
    with pytest.raises(ValueError):
        roi_align_cuda.multiscale_roi_align_cuda(
            feats, torch.empty(1, 3, 4, device="meta"))

