"""The port's RoIAlign (shared geometry + plain torch version + CUDA
wrapper), forward and backward, held against the JAX XLA path and the
Pallas kernels run in interpret mode (the CUDA kernels themselves are held
on the card by test_torch_port_cuda.py)."""

import jax
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
    roi_align_backward_from_geometry,
    roi_align_from_geometry,
    roi_geometry,
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


# -------------------------------------------------------------- backward
SHAPES = ((64, 80), (32, 40), (16, 20), (8, 10))


def _plain_grads(boxes, dout):
    """The plain backward from the boxes' geometry: dout [B, R, 7, 7, C]."""
    B, R = boxes.shape[:2]
    geom = roi_geometry(torch.from_numpy(boxes).reshape(-1, 4), SHAPES)
    return roi_align_backward_from_geometry(
        torch.from_numpy(dout).reshape(B * R, 7, 7, -1), geom, R, SHAPES)


def _bwd_boxes(rng, B, R):
    """Random rois plus the cases the TPU backward test singles out:
    overlapping rois in one image, a wide sliver across the image, a tiny
    roi; the EDGE_ROIS ride along."""
    b = _boxes(rng, B, R)
    b[0, 11] = b[0, 10] + 4.0
    b[0, 12] = [0.0, 60.0, 318.0, 70.0]
    b[1, 13] = [40.0, 40.0, 52.0, 52.0]
    return b


def _dout(rng, B, R, C=8):
    d = rng.random((B, R, 7, 7, C), dtype=np.float32)
    d[0, 4] = 0.0    # exactly-zero cotangents: unsampled slots
    d[1, 0] = 0.0
    return d


def test_plain_backward_matches_autograd_of_plain_forward(rng):
    """The plain backward is the transpose of the plain forward: torch
    autograd through the gather form gives the same gradients, float32 sums
    in another order (1e-5 of the largest gradient)."""
    B, R = 2, 24
    feats = [torch.from_numpy(f).requires_grad_() for f in _feats(rng, B)]
    boxes = _bwd_boxes(rng, B, R)
    dout = _dout(rng, B, R)
    geom = roi_geometry(torch.from_numpy(boxes).reshape(-1, 4), SHAPES)
    out = roi_align_from_geometry(feats, geom, R)
    out.backward(torch.from_numpy(dout).reshape(B * R, 7, 7, -1))
    for f, g in zip(feats, _plain_grads(boxes, dout)):
        assert g.dtype == torch.float32 and g.shape == f.shape
        scale = f.grad.abs().max().item()
        torch.testing.assert_close(g, f.grad, rtol=0, atol=1e-5 * scale)


def test_plain_backward_matches_jax_vjp(rng):
    """Against ``jax.vjp`` of the JAX XLA ``multiscale_roi_align``, per
    image: 3e-5 abs + 1e-4 rel, the tolerance the JAX package holds its
    own backward kernel to."""
    B, R = 2, 24
    feats = _feats(rng, B)
    boxes = _bwd_boxes(rng, B, R)
    dout = _dout(rng, B, R)
    ours = _plain_grads(boxes, dout)
    for b in range(B):
        _, vjp = jax.vjp(lambda fs: jax_roi_align(fs, boxes[b]),
                         tuple(jnp.asarray(f[b]) for f in feats))
        for g, r in zip(ours, vjp(jnp.asarray(dout[b]))[0]):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(r),
                                       atol=3e-5, rtol=1e-4)


def test_plain_backward_matches_pallas_interpret(rng, monkeypatch):
    """Against the TPU backward kernel (window read-modify-write, plus its
    oversized take-VJP tier for the wide sliver), interpreted on the CPU.
    ``kernel_backend`` is forced as tests/test_roi_align_pallas.py does, or
    the wrapper would take its CPU path: 3e-5 abs + 1e-4 rel."""
    import detectinblur_tpu.ops.roi_align_pallas as rap

    monkeypatch.setattr(rap, "kernel_backend", lambda: True)
    monkeypatch.setattr(rap, "_CP_CACHE", {})
    B, R = 2, 6
    feats = _feats(rng, B)
    boxes = np.zeros((B, R, 4), np.float32)
    boxes[..., 0] = rng.uniform(0, 180, (B, R))
    boxes[..., 1] = rng.uniform(0, 140, (B, R))
    boxes[..., 2] = boxes[..., 0] + rng.uniform(8, 90, (B, R))
    boxes[..., 3] = boxes[..., 1] + rng.uniform(8, 90, (B, R))
    boxes[0, 1] = boxes[0, 0] + 4.0          # overlapping rois
    boxes[0, 2] = [0.0, 60.0, 318.0, 70.0]   # wide sliver (oversized tier)
    boxes[1, 3] = [40.0, 40.0, 52.0, 52.0]   # small window class
    dout = _dout(rng, B, R)

    def loss(fs):
        out = rap.multiscale_roi_align_fused(tuple(fs), jnp.asarray(boxes),
                                             7, 2, 2, 16, 24)
        return jnp.sum(out * dout)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss)([jnp.asarray(f) for f in feats])
    for g, r in zip(_plain_grads(boxes, dout), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_on_cpu_differentiates_through_plain_backward(rng, dtype):
    """On CPU tensors the autograd Function runs the plain versions both
    ways and launches nothing: the features' gradient is the plain
    backward cast to their dtype; the boxes get none."""
    B, R = 2, 16
    feats = [torch.from_numpy(f).to(dtype).requires_grad_()
             for f in _feats(rng, B)]
    boxes = torch.from_numpy(_bwd_boxes(rng, B, R)).requires_grad_()
    dout = _dout(rng, B, R)
    before = (roi_align_cuda.roi_align_fwd.launches,
              roi_align_cuda.roi_align_bwd.launches)
    out = roi_align_cuda.multiscale_roi_align_cuda(feats, boxes)
    out.backward(torch.from_numpy(dout).to(dtype))
    assert (roi_align_cuda.roi_align_fwd.launches,
            roi_align_cuda.roi_align_bwd.launches) == before
    assert boxes.grad is None
    geom = roi_geometry(boxes.detach().reshape(-1, 4), SHAPES)
    ref = roi_align_backward_from_geometry(
        torch.from_numpy(dout).to(dtype).reshape(B * R, 7, 7, -1), geom, R,
        SHAPES)
    for f, r in zip(feats, ref):
        assert f.grad.dtype == dtype
        torch.testing.assert_close(f.grad, r.to(dtype), rtol=0, atol=0)


def test_bwd_wrapper_on_cpu_runs_plain_version_and_counts_nothing(rng):
    B, R = 1, 16
    boxes = _bwd_boxes(rng, 2, R)[:B]
    dout = _dout(rng, 2, R)[:B]
    geom = roi_geometry(torch.from_numpy(boxes).reshape(-1, 4), SHAPES)
    before = roi_align_cuda.roi_align_bwd.launches
    got = roi_align_cuda.roi_align_bwd(
        torch.from_numpy(dout).reshape(B * R, 7, 7, -1), geom, R, SHAPES,
        torch.bfloat16)
    assert roi_align_cuda.roi_align_bwd.launches == before
    for g, r in zip(got, _plain_grads(boxes, dout)):
        torch.testing.assert_close(g, r.bfloat16(), rtol=0, atol=0)


# ------------------------------------------------------------ the separable form
def _separable_axis(idx, w):
    """One axis of one roi as the CUDA backward builds it
    (``csrc/roi_align_bwd.cu``): the sorted unique rows (columns) that a
    sample corner reaches with a nonzero weight, and A [7, n] with
    A[i, r] = 1/2 * the weights of bin i's corners that land on row r."""
    i, wt = idx.reshape(-1).long(), w.reshape(-1)
    keep = wt != 0
    uniq = torch.unique(i[keep])
    a = torch.zeros(7, len(uniq))
    a.index_put_((torch.arange(i.numel())[keep] // 4,
                  torch.searchsorted(uniq, i[keep])), 0.5 * wt[keep],
                 accumulate=True)
    return uniq, a


def _separable(feats, geom, R, dout):
    """Per roi, the separable sandwiches: out = Ay F[Ys, Xs] Ax^T and the
    level gradients G = Ay^T dout Ax added once into each cell of Ys x Xs
    (the CUDA backward's algebra). Returns (out [N, 7, 7, C], 4 level
    gradients, [(|Ys|, |Xs|)] per roi)."""
    N, C = geom.level.shape[0], feats[0].shape[-1]
    out = torch.zeros(N, 7, 7, C)
    grads = [torch.zeros_like(f) for f in feats]
    sizes = []
    for n in range(N):
        lvl, b = int(geom.level[n]), n // R
        ys, ay = _separable_axis(geom.y_idx[n], geom.y_w[n])
        xs, ax = _separable_axis(geom.x_idx[n], geom.x_w[n])
        sizes.append((len(ys), len(xs)))
        cells = feats[lvl][b][ys][:, xs]                      # [ny, nx, C]
        out[n] = torch.einsum("ir,rqc,jq->ijc", ay, cells, ax)
        g = torch.einsum("ir,ijc,jq->rqc", ay, dout[n], ax)
        grads[lvl][b][ys[:, None], xs[None, :]] += g
    return out, grads, sizes


def _class_rois(rng, case, B, R):
    """[B, R, 4] rois of one of chip_smoke.py's check classes on the
    256x320 image of SHAPES."""
    from detectinblur_tpu_torch.models.anchors import grid_anchors

    H, W = 256, 320
    u = lambda lo, hi: rng.uniform(lo, hi, (B, R))
    if case == "anchors":
        p2_to_p6 = SHAPES + ((4, 5),)
        anchors = np.concatenate(grid_anchors(p2_to_p6, (H, W)))
        return anchors[rng.integers(len(anchors), size=(B, R))].astype(np.float32)
    if case == "slivers":       # 1-8 px across, tall and wide
        x, y = u(0, W), u(0, H)
        thin, long = u(1, 8), u(20, 250)
        tall = np.stack([x, y, x + thin, y + long], -1)
        wide = np.stack([x, y, x + long, y + thin], -1)
        b = np.where(np.arange(R)[None, :, None] % 2 == 0, tall, wide)
    elif case == "past_edge":
        x, y = u(-150, W), u(-150, H)
        b = np.stack([x, y, x + u(150, 450), y + u(150, 450)], -1)
    elif case == "giants":      # clamped to P5
        b = np.stack([u(-50, 50), u(-50, 50), u(1000, 2000), u(1000, 2000)], -1)
    elif case == "zeroed":      # invalid slots
        b = np.zeros((B, R, 4))
    else:                       # "border": samples where low == high
        b = np.stack([W - u(2, 10), H - u(2, 10), W + u(0, 4), H + u(0, 4)], -1)
    return b.astype(np.float32)


@pytest.mark.parametrize("case", ["anchors", "slivers", "past_edge", "giants",
                                  "zeroed", "border"])
def test_separable_form_matches_plain_and_jax(rng, case):
    """The separable form (the algebra of the CUDA backward and of the
    forward it transposes), modelled in float32 torch, on one class of
    chip_smoke.py's check rois: the forward within 1e-5 and the
    backward within 1e-5 of the largest value of the plain versions (the
    same products, summed in another order); within 2e-5 abs of JAX's
    ``multiscale_roi_align`` and 3e-5 abs + 1e-4 rel of its ``jax.vjp``
    (the tolerances above). No roi touches more than 28 rows or columns."""
    B, R = 2, 12
    feats = _feats(rng, B)
    boxes = _class_rois(rng, case, B, R)
    dout = _dout(rng, B, R)
    tf = [torch.from_numpy(f) for f in feats]
    geom = roi_geometry(torch.from_numpy(boxes).reshape(-1, 4), SHAPES)
    td = torch.from_numpy(dout).reshape(B * R, 7, 7, -1)
    out, grads, sizes = _separable(tf, geom, R, td)
    assert max(max(s) for s in sizes) <= 28
    if case == "giants":
        assert bool((geom.level == 3).all())
    if case == "border":
        assert bool(((geom.y_idx[..., 0] == geom.y_idx[..., 1])
                     & (geom.y_w[..., 0] != 0)).any())

    plain = roi_align_from_geometry(tf, geom, R)
    torch.testing.assert_close(out, plain, rtol=0,
                               atol=1e-5 * plain.abs().max().item())
    for g, r in zip(grads, roi_align_backward_from_geometry(td, geom, R,
                                                            SHAPES)):
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=1e-5 * r.abs().max().item())

    np.testing.assert_allclose(out.reshape(B, R, 7, 7, -1).numpy(),
                               _jax_expected(feats, boxes), atol=2e-5)
    for b in range(B):
        _, vjp = jax.vjp(lambda fs: jax_roi_align(fs, boxes[b]),
                         tuple(jnp.asarray(f[b]) for f in feats))
        for g, r in zip(grads, vjp(jnp.asarray(dout[b]))[0]):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(r),
                                       atol=3e-5, rtol=1e-4)
