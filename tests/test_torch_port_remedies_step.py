"""Whole remedy steps held against the JAX package on the CPU,
``highest`` precision, full ResNet50-FPN widths at a 64x64 bucket: one
``make_train_step`` step with every train-time remedy (blur, noise, block,
JPEG, GT expansion, the warp from the PSFs' principal components, the
blur-conditional norms, train-mode BatchNorm) and one ``make_eval_step``
with every eval-time remedy but JPEG (PSF dilation, blur, noise, block,
the warp, the norms, mode_one BatchNorm), JAX's draws injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remedy_helpers import (
    BUCKET,
    HW,
    N_ANCHORS,
    T,
    gt_boxes,
    jax_corruption_draws,
    jax_loss_draws,
    match,
    np_tree,
    pair,
    psfs,
    weights,
)
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

from detectinblur_tpu.train import engine as jax_engine
from detectinblur_tpu.train import state as jax_state
from detectinblur_tpu_torch.train import engine, state
from detectinblur_tpu_torch.utils.convert import params_from_jax


# ----------------------------------------------- a remedy train step
@pytest.fixture(scope="module")
def step_case():
    """One make_train_step step on both sides with every train-time remedy
    on: blur, noise, block and JPEG (the JAX draws injected), GT
    expansion, the warp from the PSFs' principal components, the
    blur-conditional norms and BatchNorm in ``train`` mode. As in
    tests/test_torch_port_train.py's step_case, every anchor is a
    proposal and every candidate roi is sampled, so float noise cannot
    change which rois the loss sums over."""
    sd = weights(seed=1)
    rpn_kw = dict(pre_nms_top_n_train=1000, post_nms_top_n_train=N_ANCHORS,
                  nms_thresh=1.0)
    box_kw = dict(batch_size_per_image=N_ANCHORS + 20, positive_fraction=0.5)
    jmodel, params, stats, model = pair(sd, "train", rpn_kw, box_kw)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    rng = np.random.default_rng(12)
    images = rng.random((2, 64, 64, 3), dtype=np.float32)
    blur_psfs = psfs(rng)[[4, 2]]
    gt, gl, gv = gt_boxes(rng)
    batch = dict(hw=HW, psfs=blur_psfs, blurring=np.array([True, False]),
                 gt_boxes=gt, gt_labels=gl, gt_valid=gv)
    idx = dict(param_index=np.array([1, -1], np.int32),
               fraction_index=np.array([2, -1], np.int32))
    flags = dict(blur_train=True, expand_target_boxes=True, use_warp=True,
                 use_custom_norm=True, add_noise=True, noise_level=0.01,
                 add_block=True, add_jpeg=True)

    # One step per epoch: no warmup, so the step's updates stand well
    # above the float32 rounding of the parameters they move.
    tx, _ = jax_state.make_optimizer(base_lr=0.02, steps_per_epoch=1,
                                     params=params)
    jstep = jax_engine.make_train_step(jmodel, tx, BUCKET, **flags)
    jbatch = jax_engine.BlurBatch(
        images=jnp.asarray(images), thetas=jnp.zeros(2), lam1s=jnp.ones(2),
        lam2s=jnp.ones(2), **{k: jnp.asarray(v) for k, v in batch.items()},
        **{k: jnp.asarray(v) for k, v in idx.items()})
    key = jax.random.key(21)
    jst = jax_state.create_train_state(jax.tree.map(jnp.array, params), tx)
    jst, jstats, jm = jstep(jst, stats, jbatch, key)

    opt, sched = state.make_optimizer(model, base_lr=0.02, steps_per_epoch=1)
    step = engine.make_train_step(model, sched, BUCKET, **flags)
    tbatch = engine.BlurBatch(images=T(images),
                              **{k: T(v) for k, v in {**batch, **idx}.items()})
    lkey, bkey = jax.random.split(key)
    st, m = step(state.create_train_state(model, opt), tbatch,
                 draws=jax_loss_draws(lkey, 2, N_ANCHORS, N_ANCHORS + 4),
                 corruption_draws=jax_corruption_draws(bkey, images.shape,
                                                        0.01))
    return ({k: float(v) for k, v in jm.items()}, np_tree(jst.params),
            np_tree(jstats), {k: v.item() for k, v in m.items()}, model, p0, st)


def test_remedy_train_step_losses_match_jax(step_case):
    jm, _, _, m, _, _, st = step_case
    assert st.step == 1
    for k, v in jm.items():
        assert np.isfinite(v), k
        np.testing.assert_allclose(m[k], v, rtol=1e-4, err_msg=k)


def test_remedy_train_step_params_and_stats_match_jax(step_case):
    """Each trainable parameter's update within 1e-2 of its largest (the
    gradients' conditioning under batch statistics, see
    test_loss_gradients_under_remedies_match_jax), the frozen ones (the
    BatchNorm affines among them) unchanged on both sides, and the
    running statistics JAX's within 3e-5 of their magnitude (as after
    the loss)."""
    _, jparams, jstats, _, model, p0, _ = step_case
    ref = params_from_jax(jparams, 5, batch_stats=jstats)
    mask = state._freeze_mask(model)
    for name, p in model.named_parameters():
        upd = (p.detach() - p0[name]).numpy()
        ref_upd = ref[name].numpy() - p0[name].numpy()
        if not mask[name]:
            assert not upd.any() and not ref_upd.any(), name
            continue
        scale = np.abs(ref_upd).max()
        assert scale > 0, name
        assert np.abs(upd - ref_upd).max() / scale <= 1e-2, name
    for k, v in model.state_dict().items():
        if k.endswith(("scale", "bias")) and "backbone.body" in k:
            assert torch.equal(v, ref[k]), k
        elif k.rpartition(".")[2] in ("running_mean", "running_var"):
            r = ref[k].numpy()
            np.testing.assert_allclose(v.numpy(), r, err_msg=k,
                                       atol=3e-5 * max(np.abs(r).max(), 1))


def test_remedy_eval_step_matches_jax(rng):
    """make_eval_step with every eval-time remedy: PSF dilation, blur,
    noise and block (JAX's sigmas and draws injected), GT expansion by
    the dilated PSFs, the warp, the norms and mode_one BatchNorm. The
    expanded GT within 1e-4 px; 85% of JAX's valid detections matched."""
    jmodel, params, stats, model = pair(weights(), "mode_one")
    images = rng.random((2, 64, 64, 3), dtype=np.float32)
    blur_psfs = psfs(rng)[[4, 5]]
    gt, gl, gv = gt_boxes(rng)
    fields = dict(hw=HW, psfs=blur_psfs, blurring=np.array([True, True]),
                  gt_boxes=gt, gt_labels=gl, gt_valid=gv,
                  param_index=np.array([0, 2], np.int32),
                  fraction_index=np.array([3, 1], np.int32))
    flags = dict(blur_eval=True, expand_target_boxes=True, use_warp=True,
                 use_custom_norm=True, add_noise=True, noise_level=0.01,
                 add_block=True, dilate_psf=True)
    key = jax.random.key(4)
    jdets, jgt = jax_engine.make_eval_step(jmodel, BUCKET, bn_stats=stats,
                                           **flags)(
        params, jax_engine.BlurBatch(
            images=jnp.asarray(images), thetas=jnp.zeros(2),
            lam1s=jnp.ones(2), lam2s=jnp.ones(2),
            **{k: jnp.asarray(v) for k, v in fields.items()}), key)
    _, bkey, dkey = jax.random.split(key, 3)
    sigma = T(np.array(jax.random.uniform(dkey, (2,), minval=0.0,
                                          maxval=3.0)))
    step = engine.make_eval_step(model, BUCKET, **flags)
    dets, got_gt = step(model, engine.BlurBatch(
        images=T(images), **{k: T(v) for k, v in fields.items()}),
        dilate_psf_sigma=sigma,
        corruption_draws=jax_corruption_draws(bkey, images.shape, 0.01))
    np.testing.assert_allclose(got_gt.numpy(), np.asarray(jgt), atol=1e-4)
    assert not np.array_equal(got_gt.numpy(), gt)
    assert min(match(dets, jdets)) > 0.85
