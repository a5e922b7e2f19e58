"""The port's box, NMS, anchor, trajectory, PSF, blur and bucket helpers
held against their JAX counterparts on the same numpy inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse fixture)

from detectinblur_tpu.data.batching import model_bucket_for_batch as jax_bucket
from detectinblur_tpu.models import anchors as jax_anchors
from detectinblur_tpu.ops import blur as jax_blur
from detectinblur_tpu.ops import boxes as jax_boxes
from detectinblur_tpu.ops import nms as jax_nms
from detectinblur_tpu.ops import psf as jax_psf
from detectinblur_tpu.ops.trajectory import sample_trajectory as jax_trajectory
from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
from detectinblur_tpu_torch.models import anchors
from detectinblur_tpu_torch.ops import blur, boxes, nms, psf
from detectinblur_tpu_torch.ops.trajectory import (
    TrajectoryDraws,
    sample_trajectory,
)

T = torch.from_numpy


def _rand_boxes(rng, n, size=100):
    b = rng.random((n, 4)).astype(np.float32) * size
    b[:, 2:] = b[:, :2] + 1 + b[:, 2:] * 0.3
    return b


# ------------------------------------------------------------------ boxes
def test_box_iou_clip_decode_match_jax(rng):
    """Elementwise float32 arithmetic in the same order: agreement to 1e-6
    relative (exp/log may differ by an ulp between the two libraries)."""
    a, b = _rand_boxes(rng, 30), _rand_boxes(rng, 20)
    np.testing.assert_allclose(boxes.box_iou(T(a), T(b)).numpy(),
                               np.asarray(jax_boxes.box_iou(a, b)),
                               rtol=1e-6, atol=1e-7)
    wide = a * 3 - 50
    np.testing.assert_array_equal(
        boxes.clip_boxes_to_image(T(wide), 90.0, 120.0).numpy(),
        np.asarray(jax_boxes.clip_boxes_to_image(wide, 90, 120)))
    # Deltas large enough that dw/dh hit the log(1000/16) clamp.
    deltas = rng.normal(0, 3, (30, 4)).astype(np.float32)
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        np.testing.assert_allclose(
            boxes.decode_boxes(T(deltas), T(a), w).numpy(),
            np.asarray(jax_boxes.decode_boxes(deltas, a, w)),
            rtol=1e-6, atol=1e-4)


# -------------------------------------------------------------------- nms
def _as_list(idxs, valid):
    return np.asarray(idxs)[np.asarray(valid)].tolist()


@pytest.mark.parametrize("n,thr,max_out", [(60, 0.5, 60), (50, 0.9, 5),
                                           (12, 0.5, 40), (300, 0.3, 150)])
def test_nms_exact_vs_jax(rng, n, thr, max_out):
    """Exact: the same keep set, order, padding and valid mask."""
    b = _rand_boxes(rng, n)
    s = rng.random(n).astype(np.float32)
    s[n // 3] = float(jax_nms.NEG_INF)            # a padding entry
    ji, jv = jax_nms.nms(b, s, thr, max_out)
    ti, tv = nms.nms(T(b), T(s), thr, max_out)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_nms_batched_leading_dims(rng):
    """A batch of problems equals the problems one by one."""
    b = np.stack([_rand_boxes(rng, 40) for _ in range(3)])
    s = rng.random((3, 40)).astype(np.float32)
    ti, tv = nms.nms(T(b), T(s), 0.5, 30)
    for i in range(3):
        ji, jv = jax_nms.nms(b[i], s[i], 0.5, 30)
        np.testing.assert_array_equal(ti[i].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv[i].numpy(), np.asarray(jv))


def test_batched_nms_exact_vs_jax(rng):
    n = 200
    b = _rand_boxes(rng, n)
    s = rng.random(n).astype(np.float32)
    cats = rng.integers(1, 6, n).astype(np.int32)
    ji, jv = jax_nms.batched_nms(b, s, cats, 0.5, 100)
    ti, tv = nms.batched_nms(T(b), T(s), T(cats), 0.5, 100)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_grouped_nms_exact_vs_jax(rng):
    """Random grouped candidates with padding tails and a mid-group mask
    (the cases of tests/test_nms.py:102)."""
    G, K = 3, 300
    bx = np.stack([_rand_boxes(rng, K) for _ in range(G)])
    sc = rng.random((G, K)).astype(np.float32)
    order = np.argsort(-sc, axis=1, kind="stable")
    sc = np.take_along_axis(sc, order, axis=1)
    bx = np.take_along_axis(bx, order[..., None], axis=1)
    sc[:, K - 5:] = float(jax_nms.NEG_INF)
    sc[1, 7] = float(jax_nms.NEG_INF)
    for max_out in (G * K, 100):
        ji, jv = jax_nms.grouped_nms_presorted(bx, sc, 0.5, max_out)
        ti, tv = nms.grouped_nms_presorted(T(bx), T(sc), 0.5, max_out)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_grouped_nms_tie_break_vs_jax():
    """Duplicated scores across groups (tests/test_nms.py:131): ties go to
    the lowest flattened index in both."""
    G, K = 4, 12
    bx = np.zeros((G, K, 4), np.float32)
    for g in range(G):
        for k in range(K):
            x = 1000.0 * g + 20.0 * k
            bx[g, k] = [x, 0.0, x + 8.0, 8.0]
    vals = np.array([0.9, 0.9, 0.7, 0.7, 0.7, 0.5, 0.5, 0.5, 0.5, 0.3,
                     0.3, 0.1], np.float32)
    sc = np.stack([vals] * G)
    ji, jv = jax_nms.grouped_nms_presorted(bx, sc, 0.5, G * K)
    ti, tv = nms.grouped_nms_presorted(T(bx), T(sc), 0.5, G * K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert _as_list(ti, tv) == np.argsort(-sc.reshape(-1), kind="stable").tolist()


# ---------------------------------------------------------------- anchors
def test_anchors_match_jax():
    shapes = ((32, 40), (16, 20), (8, 10), (4, 5), (2, 3))
    ours = anchors.grid_anchors(shapes, (128, 160))
    ref = jax_anchors.grid_anchors(shapes, (128, 160))
    for a, r in zip(ours, ref):
        np.testing.assert_array_equal(a, r)


# ------------------------------------------------------------- trajectory
def _jax_draws(keys, iters):
    """The numbers jax sample_trajectory draws, by its own split sequence
    (trajectory.py:64-90), for injection into the torch sampler."""
    def one(key):
        k_cent, k_shake, k_gauss, k_angle, k_steps = jax.random.split(key, 5)
        hyper = jnp.stack([jax.random.uniform(k)
                           for k in (k_cent, k_shake, k_gauss, k_angle)])

        def step(k):
            ku, kphase, kg = jax.random.split(k, 3)
            return (jnp.stack([jax.random.uniform(ku),
                               jax.random.uniform(kphase)]),
                    jax.random.normal(kg, (2,)))

        su, sn = jax.vmap(step)(jax.random.split(k_steps, iters - 1))
        return hyper, su, sn

    hyper, su, sn = jax.vmap(one)(keys)
    return TrajectoryDraws(T(np.array(hyper)), T(np.array(su)),
                           T(np.array(sn)))


def test_trajectory_matches_jax_with_injected_draws():
    """Same draws, same dynamics. float32 libm differences (cos/sin/sqrt
    by an ulp) accumulate over 1999 steps of a damped walk: positions
    agree to 2e-3 px, path length to 1e-4 relative, big-shake counts
    exactly."""
    iters, expl = 2000, np.array([0.005, 0.001, 0.0], np.float32)
    keys = jax.random.split(jax.random.key(3), 3)
    draws = _jax_draws(keys, iters)
    ours = sample_trajectory(draws, canvas=256, iters=iters, max_len=96.0,
                             expl=T(expl))
    for i in range(3):
        ref = jax_trajectory(keys[i], canvas=256, iters=iters, max_len=96.0,
                             expl=expl[i])
        np.testing.assert_allclose(ours.positions[i].numpy(),
                                   np.asarray(ref.positions), atol=2e-3)
        np.testing.assert_allclose(ours.tot_length[i].item(),
                                   float(ref.tot_length), rtol=1e-4)
        assert ours.big_shake_count[i].item() == int(ref.big_shake_count)


# -------------------------------------------------------------------- psf
def test_rasterize_center_crop_match_jax():
    """rasterize: exact up to float32 rounding of the splat sums (1e-7
    abs). center: fed the JAX PSF, the integer roll must be identical;
    the truncated centroid is checked to sit away from an integer (>1e-3)
    so a summation-order difference cannot legitimately move it a pixel."""
    keys = jax.random.split(jax.random.key(5), 3)
    pos = np.stack([np.asarray(jax_trajectory(k, canvas=256, iters=2000,
                                              max_len=96.0).positions)
                    for k in keys])
    fracs = np.array([0.5, 1.0, 0.1], np.float32)
    ours = psf.rasterize_psf(T(pos), 256, T(fracs))
    refs = np.stack([np.asarray(jax_psf.rasterize_psf(p, 256, f))
                     for p, f in zip(pos, fracs)])
    np.testing.assert_allclose(ours.numpy(), refs, atol=1e-7)

    for r in refs:
        w = np.where(r > 0, r, 0).astype(np.float64) / r.sum()
        c = (np.arange(256)[None] * w).sum() - 128, (np.arange(256)[:, None] * w).sum() - 128
        assert min(abs(v - round(v)) for v in c) > 1e-3
    centered = psf.center_psf(T(refs))
    jc = np.stack([np.asarray(jax_psf.center_psf(r)) for r in refs])
    np.testing.assert_array_equal(centered.numpy(), jc)
    np.testing.assert_array_equal(psf.crop_center(centered, 128).numpy(),
                                  np.stack([np.asarray(jax_psf.crop_center(c, 128))
                                            for c in jc]))


def test_sample_psf_matches_jax_with_injected_draws():
    """The whole chain from the JAX draws: mass exact to 1e-5, and the
    PSFs agree to 1e-4 of their peak (trajectory drift of <2e-3 px moves
    splat weights by about that much)."""
    keys = jax.random.split(jax.random.key(1), 2)
    draws = _jax_draws(keys, 2000)
    ours = psf.sample_psf(2, 0.005, 0.5, draws=draws).numpy()
    ref = np.asarray(jax.vmap(lambda k: jax_psf.sample_psf(k, 0.005, 0.5))(keys))
    assert ours.shape == ref.shape == (2, 128, 128)
    np.testing.assert_allclose(ours.sum((1, 2)), ref.sum((1, 2)), atol=1e-5)
    for o, r in zip(ours, ref):
        assert np.abs(o - r).max() <= 1e-4 * r.max()


def test_sample_psf_generator_is_seeded():
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    a = psf.sample_psf(2, 0.005, 0.5, iters=200, generator=g1, device="cpu")
    b = psf.sample_psf(2, 0.005, 0.5, iters=200, generator=g2, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_allclose(a.sum((1, 2)).numpy(), 0.5, atol=0.02)


# ------------------------------------------------------------------- blur
def _psfs(rng, B, k):
    p = np.zeros((B, k, k), np.float32)
    c = k // 2 - 1
    for b in range(B):
        ys = rng.integers(c - 10, c + 11, 40)
        xs = rng.integers(c - 10, c + 11, 40)
        np.add.at(p[b], (ys, xs), rng.random(40).astype(np.float32))
    return p


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("k", [128, 256])
def test_batched_blur_matches_jax(rng, exact, k):
    """Without ``hw`` (whole canvas) and with ``hw`` (valid regions,
    including one below 64 px that pads with zeros). float32 FFTs of two
    libraries: 2e-5 abs on [0, 1] images."""
    B, C, H, W = 3, 3, 70, 90
    imgs = rng.random((B, C, H, W)).astype(np.float32)
    psfs = _psfs(rng, B, k)
    on = np.array([True, True, False])
    hw = np.array([[70, 90], [50, 80], [66, 64]], np.int32)
    for hw_arg in (None, hw):
        ref = np.asarray(jax_blur.batched_blur(
            imgs, psfs, on, exact=exact,
            hw=None if hw_arg is None else jnp.asarray(hw_arg)))
        ours = blur.batched_blur(T(imgs), T(psfs), T(on), exact=exact,
                                 hw=None if hw_arg is None else T(hw_arg))
        np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)


def test_pad_for_blur_matches_jax(rng):
    imgs = rng.random((2, 2, 64, 70)).astype(np.float32)
    hw = np.array([[64, 70], [40, 30]], np.int32)
    for k in (128, 256):
        ours = blur.pad_for_blur(T(imgs), k, T(hw)).numpy()
        ours_full = blur.pad_for_blur(T(imgs), k).numpy()
        for b in range(2):
            np.testing.assert_array_equal(
                ours[b], np.asarray(jax_blur.pad_for_blur(imgs[b], k,
                                                          jnp.asarray(hw[b]))))
            np.testing.assert_array_equal(
                ours_full[b], np.asarray(jax_blur.pad_for_blur(imgs[b], k)))
    for n in (100, 607, 767, 1216):
        assert blur._fast_fft_size(n) == jax_blur._fast_fft_size(n)


# ----------------------------------------------------------------- bucket
def test_model_bucket_matches_jax():
    for hw in ([[480, 640]] * 8, [[427, 640], [640, 480]], [[110, 150]]):
        assert model_bucket_for_batch(hw) == jax_bucket(hw)
        assert (model_bucket_for_batch(hw, 128, 160)
                == jax_bucket(hw, 128, 160))
