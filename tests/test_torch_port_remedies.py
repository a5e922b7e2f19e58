"""The port's remedy modules held against the JAX package on the CPU: PSF
analysis and dilation, the Squint warp, the blur-conditional
normalization, the BatchNorm modes, the JPEG and the corruption chain,
AugMix, and the BatchNorm routes of the weight converters, the freeze
mask and the checkpoints. The detector under the remedies is in
tests/test_torch_port_remedies_model.py and _step.py.

Random draws: the port takes the values JAX draws from its keys
(``remedy_helpers.jax_corruption_draws``), so a random remedy matches
exactly where its arithmetic does.

JPEG rounding: the differentiable rounding round(x) + (x - round(x))^3
jumps by 0.75 of a quantization step where a coefficient crosses a .5
tie, and the port's DCT (one [64, 64] product) sums in another order than
JAX's tensordot. Coefficients are held to 1e-4 of their magnitude; images
are held to float noise on every 16x16 macroblock none of whose
quantized coefficients lies within 1e-4 of a tie, and the share of the
other macroblocks is bounded and printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remedy_helpers import T, jax_corruption_draws, np_tree, psfs, weights
from synthetic_coco import write_coco
from torch_reference import make_random_fasterrcnn_sd
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

from detectinblur_tpu.data import batching as jax_batching
from detectinblur_tpu.data import loader as jax_loader
from detectinblur_tpu.data.blur_sampling import BlurPolicy as JaxPolicy
from detectinblur_tpu.data.coco import get_coco as jax_get_coco
from detectinblur_tpu.models import batchnorm as jax_bn
from detectinblur_tpu.models import detection_transform as jax_dt
from detectinblur_tpu.ops import jpeg as jax_jpeg
from detectinblur_tpu.ops import normalization as jax_norm
from detectinblur_tpu.ops import psf as jax_psf
from detectinblur_tpu.ops import warp as jax_warp
from detectinblur_tpu.train import state as jax_state
from detectinblur_tpu.train.estimator_engine import (
    apply_corruptions as jax_apply_corruptions,
)
from detectinblur_tpu.utils.torch_convert import (
    convert_fasterrcnn_bn_stats,
    convert_fasterrcnn_state_dict,
)
from detectinblur_tpu_torch.data import batching, loader
from detectinblur_tpu_torch.data.blur_sampling import BlurPolicy
from detectinblur_tpu_torch.data.coco import get_coco
from detectinblur_tpu_torch.models import batchnorm, detection_transform
from detectinblur_tpu_torch.models.faster_rcnn import (
    FasterRCNN,
    FasterRCNNConfig,
)
from detectinblur_tpu_torch.ops import jpeg, normalization, psf, warp
from detectinblur_tpu_torch.train import state
from detectinblur_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from detectinblur_tpu_torch.train.estimator_engine import apply_corruptions
from detectinblur_tpu_torch.utils.convert import (
    params_from_jax,
    params_from_torchvision,
)


# ------------------------------------------------------ PSF analysis
def test_psf_principal_components_matches_jax(rng):
    """theta and both scale factors within 1e-5 (float32 sums over the
    support in another order); the empty PSF included."""
    p = psfs(rng)
    ours = psf.psf_principal_components(T(p))
    for i in range(len(p)):
        ref = jax_psf.psf_principal_components(p[i])
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o[i].item(), float(r), atol=1e-5,
                                       rtol=1e-5, err_msg=str(i))


@pytest.mark.parametrize("sigmas", [[0.0, 0.4, 1.3, 3.0, 2.2, 0.9],
                                    [3.0, 3.0, 1e-7, 0.05, 1.0, 2.5]])
def test_dilate_psf_matches_jax(rng, sigmas):
    """Injected sigmas, zero and tiny ones included: within 1e-6 of the
    max-normalized PSF (the same separable taps, summed in another
    order); the support (what the GT expansion reads) is JAX's exactly:
    the port zeroes values below float32's smallest normal, which XLA's
    CPU flushes."""
    p = psfs(rng)[1:]
    s = np.asarray(sigmas[:len(p)], np.float32)
    ours = psf.dilate_psf(T(p), T(s)).numpy()
    for i in range(len(p)):
        ref = np.asarray(jax_psf.dilate_psf(p[i], s[i]))
        np.testing.assert_allclose(ours[i], ref, atol=1e-6, err_msg=str(i))
        np.testing.assert_array_equal(ours[i] > 0, ref > 0)


# ------------------------------------------------------------- warp
def test_squint_matrix_matches_jax(rng):
    th = rng.uniform(-3, 3, 8).astype(np.float32)
    l1, l2 = (rng.uniform(0.7, 1.0, 8).astype(np.float32) for _ in range(2))
    ours = warp.squint_matrix(T(th), T(l1), T(l2)).numpy()
    for i in range(8):
        ref = jax_warp.squint_matrix(th[i], l1[i], l2[i], 20, 30)
        np.testing.assert_allclose(ours[i], np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 24, 30, 3), (2, 17, 13, 32)])
def test_squint_warp_matches_jax(rng, shape):
    """An image and a feature map, each image its own warp (the inverse
    one included): within 1e-5 of the input's scale; contiguous NHWC
    out, as the RoIAlign kernel reads it."""
    x = rng.standard_normal(shape).astype(np.float32)
    th = np.array([0.4, -1.1], np.float32)
    l1 = np.array([0.9, 1 / 0.8], np.float32)
    l2 = np.array([1.0, 1 / 0.85], np.float32)
    ours = warp.squint_warp(T(x), T(th), T(l1), T(l2))
    ref = np.asarray(jax_warp.squint_warp(x, th, l1, l2))
    assert ours.is_contiguous() and ours.shape == shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5 * np.abs(x).max())


def test_identity_warp_is_identity_to_rounding(rng):
    """theta 0, lambda 1 (an image that is not blurred): the grid sits on
    the pixel centres up to float32 rounding, so the warp gives back its
    input within 1e-5 of its scale, not bit for bit; bfloat16 in,
    bfloat16 out."""
    x = rng.standard_normal((1, 40, 52, 8)).astype(np.float32)
    one = torch.ones(1)
    out = warp.squint_warp(T(x), torch.zeros(1), one, one)
    print(f"identity warp: max |out - in| {np.abs(out.numpy() - x).max():.3g}")
    np.testing.assert_allclose(out.numpy(), x, atol=1e-5 * np.abs(x).max())
    xb = T(x).bfloat16()
    assert warp.squint_warp(xb, torch.zeros(1), one, one).dtype == torch.bfloat16


# ----------------------------------------------------- normalization
def test_get_norm_params_matches_jax():
    """Exact, every (param, fraction) cell and each fallback: not
    blurred, param_index -1, fraction_index -1."""
    p = np.array([0, 1, 2, 2, 0, -1, 1, 2], np.int32)
    f = np.array([0, 4, 3, -1, 2, 1, 0, 4], np.int32)
    on = np.array([1, 1, 1, 1, 0, 1, 1, 1], bool)
    ours = normalization.get_norm_params(T(on), T(p), T(f))
    ref = jax_norm.get_norm_params(jnp.asarray(on), jnp.asarray(p),
                                   jnp.asarray(f))
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    np.testing.assert_array_equal(normalization.STD_TABLE, jax_norm.STD_TABLE)
    assert not np.array_equal(ours[1][0].numpy(), ours[1][4].numpy())


def test_preprocess_batch_with_norms_matches_jax(rng):
    """Per-image means and stds: within 1e-5 (the resize's float32 sums)."""
    img = rng.random((2, 60, 70, 3)).astype(np.float32)
    hw = np.array([[60, 70], [48, 64]], np.int32)
    means = rng.uniform(0.3, 0.6, (2, 3)).astype(np.float32)
    stds = rng.uniform(0.15, 0.3, (2, 3)).astype(np.float32)
    ours, nhw = detection_transform.preprocess_batch(
        T(img), hw, (96, 128), 96, 128, means=T(means), stds=T(stds))
    ref, rhw = jax_dt.preprocess_batch(img, hw, (96, 128), means, stds, 96,
                                       128)
    np.testing.assert_array_equal(nhw.numpy(), np.asarray(rhw))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


# -------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("mode", ["train", "eval", "acclimation", "mode_one"])
def test_adaptive_batchnorm_matches_jax(rng, mode):
    """The output within 1e-5 of its scale, and in training mode the
    running statistics JAX's ``mutable`` apply returns (train and
    acclimation update them, with the unbiased variance and the count),
    within 1e-6; outside training mode nothing is written."""
    x = (rng.standard_normal((2, 6, 7, 5)) * 2 + 0.5).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
              "bias": rng.normal(0, 0.3, 5).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.3, 5).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 5).astype(np.float32),
             "num_batches_tracked": np.float32(7.0)}
    jm = jax_bn.AdaptiveBatchNorm(5, mode=mode)
    ref, new = jm.apply({"params": params, "batch_stats": stats}, x,
                        mutable=["batch_stats"])
    new = np_tree(new["batch_stats"])
    m = batchnorm.AdaptiveBatchNorm(5, mode=mode)
    m.load_state_dict(params_from_leaves(params, stats))
    xt = T(x).permute(0, 3, 1, 2)
    m.eval()
    out = m(xt).permute(0, 2, 3, 1).detach().numpy()
    assert m.num_batches_tracked.item() == 7.0
    np.testing.assert_array_equal(m.running_mean.numpy(), stats["mean"])
    m.train()
    out_train = m(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_array_equal(out_train, out)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(m.running_mean.numpy(), new["mean"], atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), new["var"], atol=1e-6)
    assert m.num_batches_tracked.item() == float(new["num_batches_tracked"])
    assert (float(new["num_batches_tracked"]) == 8.0) == (
        mode in ("train", "acclimation"))


def params_from_leaves(params, stats):
    return {"scale": T(params["scale"]), "bias": T(params["bias"]),
            "running_mean": T(stats["mean"]), "running_var": T(stats["var"]),
            "num_batches_tracked": torch.tensor(stats["num_batches_tracked"])}


def test_batchnorm_stats_are_float32_over_the_canvas():
    """bfloat16 activations: the statistics are float32 sums over N, H, W
    of the whole canvas, zero padding included, as in JAX."""
    m = batchnorm.AdaptiveBatchNorm(2, mode="train").train()
    x = torch.zeros(1, 2, 4, 4)
    x[:, :, :2, :2] = 3.0                       # a quarter valid, rest pad
    m(x.bfloat16())
    np.testing.assert_allclose(m.running_mean.numpy(), [0.075, 0.075])
    assert m.running_var.dtype == torch.float32
    with pytest.raises(ValueError, match="mode"):
        batchnorm.AdaptiveBatchNorm(2, mode="frozen")


def test_set_num_batches_tracked_matches_jax():
    sd = make_random_fasterrcnn_sd(np.random.default_rng(0), num_classes=5)
    ref = jax_bn.set_num_batches_tracked(convert_fasterrcnn_bn_stats(sd), 16.0)
    model = FasterRCNN(FasterRCNNConfig(num_classes=5, bn_mode="mode_one",
                                        precision="highest"), device="cpu")
    batchnorm.set_num_batches_tracked(model, 16.0)
    want = params_from_jax(np_tree(convert_fasterrcnn_state_dict(
        sd, frozen_bn=False)), 5, batch_stats=np_tree(ref))
    counts = {k: v for k, v in model.state_dict().items()
              if k.endswith("num_batches_tracked")}
    assert len(counts) == 53
    assert all(torch.equal(v, want[k]) for k, v in counts.items())


# ------------------------------------------------------------- JPEG
def _tie_macroblocks(img, quality, tol=1e-4):
    """[B, H/16, W/16]: the macroblocks with a quantized coefficient within
    ``tol`` of a .5 tie (Y blocks and their chroma block), by the port's
    own DCT."""
    B, H, W, _ = img.shape
    factor = jpeg.quality_to_factor(quality).reshape(-1, 1, 1)
    out = torch.zeros(B, H // 16, W // 16, dtype=torch.bool)
    for c, table, step in zip(jpeg.jpeg_planes(img),
                              (jpeg.Y_TABLE, jpeg.C_TABLE, jpeg.C_TABLE),
                              (2, 1, 1)):
        x = jpeg.jpeg_dct(c) / (T(table).reshape(1, 1, 64) * factor)
        near = ((x - torch.floor(x) - 0.5).abs() < tol).any(-1)
        h, w = c.shape[1] // 8, c.shape[2] // 8
        near = near.reshape(B, h // step, step, w // step, step).any(4).any(2)
        out |= near
    return out


def _macro_mask(mask):
    m = mask.to(torch.uint8).repeat_interleave(16, 1).repeat_interleave(16, 2)
    return m.bool()[..., None]


@pytest.mark.parametrize("quality", [20.0, 50.0, 87.5])
def test_jpeg_matches_jax(rng, quality):
    """The DCT coefficients within 1e-4 of their magnitude; the
    decompressed images within 2e-6 on the macroblocks without a
    coefficient within 1e-4 of a tie (a float32 DCT differs by far less;
    see the module docstring), at most 25% of macroblocks with one (white
    noise, the worst case: every coefficient is spread)."""
    img = rng.random((2, 64, 96, 3)).astype(np.float32)
    img[1] = np.clip(img[0] * 0.3 + 0.4, 0, 1)     # a smoother one
    y, _, _ = jpeg.jpeg_planes(T(img))
    for b in range(2):
        ycbcr = img[b] * 255.0 @ jax_jpeg._RGB2YCBCR + jax_jpeg._YCBCR_SHIFT
        ref = np.asarray(jax_jpeg._dct(jax_jpeg._blocks(ycbcr[..., 0])))
        ours = jpeg.jpeg_dct(y[b:b + 1])[0].numpy().reshape(-1, 8, 8)
        np.testing.assert_allclose(ours, ref, atol=1e-4 * np.abs(ref).max())
    out = jpeg.jpeg_compress_decompress(T(img), quality).numpy()
    ties = _tie_macroblocks(T(img), torch.tensor(quality))
    keep = ~_macro_mask(ties).numpy()
    print(f"quality {quality}: {ties.float().mean().item():.1%} of "
          f"macroblocks hold a coefficient within 1e-4 of a tie")
    assert ties.float().mean() <= 0.25
    for b in range(2):
        ref = np.asarray(jax_jpeg.jpeg_compress_decompress(img[b], quality))
        k = np.broadcast_to(keep[b], ref.shape)
        np.testing.assert_allclose(out[b][k], ref[k], atol=2e-6)
        assert np.abs(out[b] - img[b]).max() > 0.01


def test_add_jpeg_artifact_matches_jax(rng):
    """Reflect padding to a multiple of 16 (a whole 16 on an aligned side)
    and the crop back: the same shape, within 2e-6 where no tie sits."""
    img = rng.random((40, 48, 3)).astype(np.float32)
    ours = jpeg.add_jpeg_artifact(T(img), 60.0).numpy()
    ref = np.asarray(jax_jpeg.add_jpeg_artifact(img, 60.0))
    assert ours.shape == ref.shape == img.shape
    close = np.abs(ours - ref) <= 2e-6
    assert close.mean() > 0.9


# ------------------------------------------------------ corruptions
CORRUPTIONS = {"noise": (True, False, False), "block": (False, True, False),
               "jpeg": (False, False, True), "all": (True, True, True)}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_apply_corruptions_matches_jax(rng, name):
    """The JAX draws injected: noise and block exactly (the block indices
    are floor(i / s) * s in float32 on both sides), JPEG as in
    test_jpeg_matches_jax; 4 images, so both sides of each decision
    show."""
    noise, block, jp = CORRUPTIONS[name]
    img = rng.random((4, 48, 64, 3)).astype(np.float32)
    key = jax.random.key(11)
    draws = jax_corruption_draws(key, img.shape, 0.01)
    ref = np.asarray(jax_apply_corruptions(key, jnp.asarray(img), noise, 0.01,
                                           block, jp))
    ours = apply_corruptions(T(img), noise, 0.01, block, jp, draws=draws)
    keep = np.ones_like(img, bool)
    if jp:
        before = apply_corruptions(T(img), noise, 0.01, block, False,
                                   draws=draws)
        ties = _tie_macroblocks(before, draws.jpeg_quality)
        ties &= (draws.jpeg_u > 0.35)[:, None, None]
        keep = np.broadcast_to(~_macro_mask(ties).numpy(), img.shape)
    np.testing.assert_allclose(ours.numpy()[keep], ref[keep],
                               atol=2e-6 if jp else 0)
    if block:
        on = (draws.block_u > 0.5).numpy()
        assert on.any() and not on.all()
    assert not np.array_equal(ours.numpy(), img)


def test_corruptions_from_a_generator_stay_in_range():
    """Drawn from a torch generator: the same draws for the same seed,
    values in 0..1, and every corruption applied per image."""
    img = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    outs = [apply_corruptions(img, True, 0.01, True, True,
                              generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert outs[0].min() >= 0 and outs[0].max() <= 1
    assert not torch.equal(outs[0], img)


# ----------------------------------------------------------- AugMix
SIZES = {"train2017": [(40, 48), (48, 40), (44, 44), (36, 48), (40, 40),
                       (48, 48)]}


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return write_coco(str(tmp_path_factory.mktemp("coco")), SIZES, seed=3,
                      n_cats=5, boxes=(1, 4))


@pytest.mark.parametrize("cfg", [
    dict(positional=True), dict(positional=True, modify_target_boxes=True),
    dict(positional=False, modify_target_boxes=True, severity=3, depth=2)],
    ids=["positional", "positional-boxes", "fixed-severity"])
def test_augmix_loader_batches_match_jax(coco_root, monkeypatch, cfg):
    """Exact batches (images, moved GT boxes, blur fields) from both
    loaders with AugMix on, through hflip and the blur decisions."""
    for mod in (batching, jax_batching):
        monkeypatch.setattr(mod, "DEFAULT_SOURCE_BUCKETS", ((48, 48),))
    bank = np.random.default_rng(4).random((3, 5, 2, 128, 128)).astype(np.float32)
    kw = dict(batch_size=2, psf_bank=bank, shuffle=True, hflip_prob=0.5,
              augmix=cfg, num_workers=2)
    got = list(loader.DetectionLoader(get_coco(coco_root, "train"),
                                      policy=BlurPolicy(prob=0.5), **kw))
    want = list(jax_loader.DetectionLoader(jax_get_coco(coco_root, "train"),
                                           policy=JaxPolicy(prob=0.5), **kw))
    assert len(got) == len(want) == 3
    for (ob, _, oids), (rb, _, rids) in zip(got, want):
        assert oids == rids
        for name in batching.BlurBatch._fields:
            np.testing.assert_array_equal(getattr(ob, name).numpy(),
                                          np.asarray(getattr(rb, name)),
                                          err_msg=name)
    plain = list(loader.DetectionLoader(get_coco(coco_root, "train"),
                                        policy=BlurPolicy(prob=0.5),
                                        **dict(kw, augmix=None)))
    for (ob, _, _), (pb, _, _) in zip(got, plain):
        assert not torch.equal(ob.images, pb.images)


@pytest.mark.parametrize("positional,modify", [(False, False), (True, False),
                                               (True, True)])
def test_augment_and_mix_matches_jax(rng, positional, modify):
    """One uint8 image with boxes, the same numpy stream on both sides:
    the mixed image and the boxes exactly; the boxes move only when the
    positional ops may move them."""
    from detectinblur_tpu.data.augmix import augment_and_mix as jax_augmix
    from detectinblur_tpu_torch.data.augmix import augment_and_mix

    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    boxes = np.array([[5, 6, 30, 25], [20, 10, 50, 38]], np.float32)
    moved = False
    for seed in range(6):
        kw = dict(boxes=boxes, positional=positional,
                  modify_target_boxes=modify)
        ours = augment_and_mix(img, np.random.default_rng(seed), **kw)
        ref = jax_augmix(img, np.random.default_rng(seed), **kw)
        np.testing.assert_array_equal(ours[0], ref[0])
        np.testing.assert_array_equal(ours[1], ref[1])
        assert ref[2] is None and ours[0].dtype == np.float32
        moved |= not np.array_equal(ours[1], boxes)
    assert moved == (positional and modify)


# ------------------------------------------- weights and checkpoints
def test_converters_take_the_bn_trees():
    """params_from_torchvision's unfolded route is, bit for bit, the JAX
    converters' (params and batch_stats) through params_from_jax."""
    sd = weights()
    ours = params_from_torchvision(sd, 5, frozen_bn=False, num_batches=16.0)
    ref = params_from_jax(
        np_tree(convert_fasterrcnn_state_dict(sd, frozen_bn=False)), 5,
        batch_stats=np_tree(convert_fasterrcnn_bn_stats(sd, num_batches=16.0)))
    assert ours.keys() == ref.keys()
    assert all(torch.equal(ours[k], ref[k]) for k in ref)
    assert torch.equal(ours["backbone.body.bn1.scale"],
                       T(sd["backbone.body.bn1.weight"]))
    with pytest.raises(KeyError, match="running_mean"):
        params_from_jax(np_tree(convert_fasterrcnn_state_dict(sd)), 5,
                        batch_stats={"backbone": {"body": {}}})


def test_freeze_mask_with_batchnorm_matches_jax():
    """A bn_mode model's trainable parameters are JAX's mask on its
    unfolded tree, parameter for parameter: the BatchNorm affines are
    parameters, and the mask keeps them frozen as JAX's does."""
    sd = weights()
    tree = convert_fasterrcnn_state_dict(sd, frozen_bn=False)
    model = FasterRCNN(FasterRCNNConfig(num_classes=5, bn_mode="train",
                                        precision="highest"), device="meta")
    ours = state._freeze_mask(model)
    ref = params_from_jax(jax.tree.map(
        lambda m, p: np.full(np.shape(p), m, np.float32),
        jax_state._freeze_mask(tree), np_tree(tree)), 5)
    assert set(ours) == set(ref)
    for name, value in ref.items():
        assert ours[name] == bool(value.flatten()[0]), name
    assert not ours["backbone.body.layer3_0.bn2.scale"]


def test_checkpoint_round_trips_bn_buffers(tmp_path):
    """The running statistics and counts come back bit for bit in
    model_{epoch}.pt, and strict loading still catches a missing one."""
    model = FasterRCNN(FasterRCNNConfig(num_classes=5, bn_mode="train",
                                        precision="highest"), device="cpu")
    model.load_state_dict(params_from_torchvision(weights(), 5,
                                                  frozen_bn=False,
                                                  num_batches=3.0))
    opt, _ = state.make_optimizer(model)
    path = save_checkpoint(str(tmp_path), state.create_train_state(model, opt),
                           0)
    fresh = FasterRCNN(model.cfg, device="cpu", seed=1)
    got = restore_checkpoint(path, state.create_train_state(
        fresh, state.make_optimizer(fresh)[0]))
    for (k, v), w in zip(got.model.state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(v, w), k
    assert fresh.backbone.body.layer3_2.bn2.num_batches_tracked.item() == 3.0
    ckpt = torch.load(path, weights_only=True)
    del ckpt["model"]["backbone.body.layer2_0.bn1.running_var"]
    torch.save(ckpt, tmp_path / "cut.pt")
    with pytest.raises(KeyError, match="running_var"):
        restore_checkpoint(str(tmp_path / "cut.pt"), state.create_train_state(
            fresh, state.make_optimizer(fresh)[0]))


def test_unfrozen_pretrained_start_differs_from_jax(tmp_path):
    """A fault of the reference, not copied (ROADMAP Queue 3): JAX's
    cli.train --unfrozen_batch_norm --pretrained folds the .pth's
    BatchNorm into scale and bias and starts from fresh statistics (mean
    0, var 1), so its train-mode BatchNorm applies gamma/sqrt(var) where
    the reference applies gamma. The port loads gamma, beta and the
    file's statistics."""
    import argparse

    import detectinblur_tpu.cli.train as jax_cli_train
    import detectinblur_tpu_torch.cli.train as cli_train

    sd = make_random_fasterrcnn_sd(np.random.default_rng(0))
    pth = tmp_path / "w.pth"
    torch.save({k: T(v) for k, v in sd.items()}, pth)
    args = argparse.Namespace(pretrained=False, start_from_weights=str(pth),
                              output_dir=str(tmp_path), warp_in_model=False,
                              unfrozen_batch_norm=True)
    jmodel = jax_cli_train.build_model(
        argparse.Namespace(model="fasterrcnn_resnet50_fpn", dataset="coco",
                           warp_in_model=False), bn_mode="train")
    jmodel.init = lambda key: None     # replaced by the converted .pth
    jparams, jstats = jax_cli_train.load_initial_params(args, jmodel, "fresh")
    model = cli_train.load_initial_params(args, FasterRCNN(FasterRCNNConfig(
        bn_mode="train", precision="highest"), device="cpu"))
    gamma = sd["backbone.body.bn1.weight"]
    var = sd["backbone.body.bn1.running_var"]
    jscale = np.asarray(jparams["backbone"]["body"]["bn1"]["scale"])
    np.testing.assert_allclose(jscale, gamma / np.sqrt(var), rtol=1e-6)
    assert jstats == "fresh"           # the caller's fresh statistics
    bn1 = model.backbone.body.bn1
    np.testing.assert_array_equal(bn1.scale.detach().numpy(), gamma)
    np.testing.assert_array_equal(bn1.running_var.numpy(), var)
    assert np.abs(bn1.scale.detach().numpy() - jscale).max() > 1e-3
