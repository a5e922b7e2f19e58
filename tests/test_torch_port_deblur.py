"""The port's deblur-first held against the JAX package on the CPU: the
PixelShuffle order, the Gaussian pyramid, DeepDeblur's MSResNet through
``deblur_image``, the DeepDeblur converter, and the eval preamble with a
deblurrer. MSResNet at 3 scales, 8 features and 2 blocks, on an odd
37x53 canvas so that the edge pad to /4 and the unpad both matter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_torch import synthetic_deepdeblur_state_dict
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

from detectinblur_tpu.models import deblur as jax_deblur
from detectinblur_tpu.train import engine as jax_engine
from detectinblur_tpu_torch.models import deblur
from detectinblur_tpu_torch.train import engine
from detectinblur_tpu_torch.utils.convert import deepdeblur_from_torch

T = torch.from_numpy
H, W = 37, 53


@pytest.fixture(scope="module")
def sd():
    return synthetic_deepdeblur_state_dict(n_scales=3, feats=8, n_blocks=2,
                                           seed=4)


@pytest.fixture(scope="module")
def nets(sd):
    return (deblur.MSResNet.from_state_dict(deepdeblur_from_torch(sd)),
            jax_deblur.convert_deepdeblur_state_dict(sd))


def test_pixel_shuffle_matches_jax():
    """Exact: torch's PixelShuffle, which MSResNet runs, on [B, C*4, H, W]
    against JAX's ``pixel_shuffle`` on [H, W, C*4]."""
    x = np.random.default_rng(0).random((5, 7, 12), np.float32)
    ours = torch.nn.functional.pixel_shuffle(T(x.transpose(2, 0, 1))[None], 2)
    ref = np.asarray(jax_deblur.pixel_shuffle(jnp.asarray(x), 2))
    np.testing.assert_array_equal(ours[0].permute(1, 2, 0).numpy(), ref)


def test_gaussian_pyramid_matches_jax():
    """Each level within 1e-6 of JAX's on a 0..1 image (float32 sums of
    seven taps; the symmetric padding reaches the edges of 37x53 and of
    the coarser 19x27 and 10x14)."""
    img = np.random.default_rng(1).random((H, W, 3), np.float32)
    ours = deblur.gaussian_pyramid(T(img.transpose(2, 0, 1))[None], 3)
    ref = jax_deblur.gaussian_pyramid(jnp.asarray(img), 3)
    assert [tuple(o.shape[2:]) for o in ours] == [(37, 53), (19, 27), (10, 14)]
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o[0].permute(1, 2, 0).numpy(),
                                   np.asarray(r), rtol=0, atol=1e-6)


def test_deblur_image_matches_jax(nets):
    """``deblur_image`` on a batch of two 37x53 images against JAX's,
    vmapped as its eval preamble runs it: within 2e-6 (float32 through 15
    convs on the 0..255 scale, mapped back to 0..1); the output differs
    from the input, and stays in 0..1."""
    net, variables = nets
    imgs = np.random.default_rng(2).random((2, H, W, 3), np.float32)
    ours = deblur.deblur_image(net, T(imgs)).numpy()
    ref = np.asarray(jax.vmap(lambda im: jax_deblur.deblur_image(
        variables, im))(jnp.asarray(imgs)))
    assert ours.shape == imgs.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-6)
    assert np.abs(ours - imgs).max() > 1e-3
    assert ours.min() >= 0.0 and ours.max() <= 1.0


def test_deepdeblur_converter_matches_jax_and_is_strict(sd, nets):
    """The converted state dict is JAX's tree, kernel HWIO -> OIHW, bit
    for bit; the architecture is inferred (3 scales, 8 features, kernel 5,
    2 blocks). A missing key, an extra key and a wrong shape raise."""
    net, variables = nets
    ours = deepdeblur_from_torch(sd)
    flat = {}
    for path, v in jax.tree_util.tree_flatten_with_path(
            variables["params"])[0]:
        head = ".".join(str(k.key) for k in path[:-1])
        leaf = str(path[-1].key)
        v = np.asarray(v)
        flat[f"{head}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
            v.transpose(3, 2, 0, 1) if leaf == "kernel" else v)
    assert sorted(ours) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert (net.n_scales, net.scale0.n_blocks) == (3, 2)
    assert tuple(net.scale0.head.weight.shape) == (8, 6, 5, 5)
    cut = dict(sd)
    del cut["body_models.1.body.2.body.0.bias"]
    with pytest.raises(KeyError, match="body_models.1.body.2.body.0.bias"):
        deepdeblur_from_torch(cut)
    with pytest.raises(KeyError, match="unused"):
        deepdeblur_from_torch(dict(sd, **{"body_models.0.extra.weight":
                                          np.zeros(3, np.float32)}))
    bad = dict(sd)
    bad["conv_end_models.2.uppath.0.weight"] = np.zeros((12, 3, 3, 3),
                                                        np.float32)
    with pytest.raises(ValueError, match="shape"):
        deepdeblur_from_torch(bad)


def test_prepare_eval_batch_deblurs_after_the_blur_as_jax(nets):
    """The eval preamble with a deblurrer: blur (one image blurred, one
    not), then deblur-first on the whole canvas of both, as JAX's; the GT
    boxes are left alone. Within 2e-6, as ``deblur_image``."""
    net, variables = nets
    rng = np.random.default_rng(3)
    images = rng.random((2, 40, 56, 3), np.float32)
    hw = np.array([[H, W], [32, 40]], np.int32)
    psfs = np.zeros((2, 128, 128), np.float32)
    psfs[:, 60:66, 58:70] = rng.random((2, 6, 12))
    gt = rng.uniform(0, 30, (2, 3, 4)).astype(np.float32)
    gt[..., 2:] += 5
    fields = dict(hw=hw, psfs=psfs, blurring=np.array([True, False]),
                  gt_boxes=gt, gt_labels=np.ones((2, 3), np.int64),
                  gt_valid=np.ones((2, 3), bool))
    ours = engine.prepare_eval_batch(
        engine.BlurBatch(images=T(images), **{k: T(v) for k, v in
                                              fields.items()}),
        blur_eval=True, deblurrer=net)
    ref = jax_engine.prepare_eval_batch(
        jax_engine.BlurBatch(
            images=jnp.asarray(images), thetas=jnp.zeros(2),
            lam1s=jnp.ones(2), lam2s=jnp.ones(2),
            param_index=jnp.array([1, -1]), fraction_index=jnp.array([2, -1]),
            **{k: jnp.asarray(v) for k, v in fields.items()}),
        None, blur_eval=True, deblur_vars=variables)
    np.testing.assert_allclose(ours.images.numpy(), np.asarray(ref.images),
                               rtol=0, atol=2e-6)
    np.testing.assert_array_equal(ours.gt_boxes.numpy(), gt)
    plain = engine.prepare_eval_batch(engine.BlurBatch(
        images=T(images), **{k: T(v) for k, v in fields.items()}),
        blur_eval=True)
    assert (ours.images - plain.images).abs().max() > 1e-3
