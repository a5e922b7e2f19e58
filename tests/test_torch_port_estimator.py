"""The port's blur estimator held against the JAX package on the CPU: the
label and specialist maps, the resnet18 classifier in both BatchNorm
modes, its two converters, the estimator's resizes, crop and blur, one
train step (JAX's corruption draws injected) and the eval step; and the
BatchNorm repairs that the estimator needed (trainable affines, float32
output under ``default`` precision).

resnet18 runs on 64x96 inputs from a torchvision-layout state dict
(``tests/synthetic_torch.py``'s layout, He-scaled here so that eval-mode
BatchNorm keeps the activations finite)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from remedy_helpers import jax_corruption_draws, np_tree, resnet18_sd
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

from detectinblur_tpu.models import classifier as jax_cls
from detectinblur_tpu.models import detection_transform as jax_dt
from detectinblur_tpu.train import engine as jax_engine
from detectinblur_tpu.train import estimator_engine as jax_est
from detectinblur_tpu.train.state import TrainState as JaxTrainState
from detectinblur_tpu.train.state import make_lr_schedule as jax_schedule
from detectinblur_tpu.utils.torch_convert import (
    convert_resnet_classifier_state_dict,
)
from detectinblur_tpu_torch.models import classifier as cls
from detectinblur_tpu_torch.models import detection_transform as dt
from detectinblur_tpu_torch.train import engine
from detectinblur_tpu_torch.train import estimator_engine as est
from detectinblur_tpu_torch.train.state import TrainState, make_lr_schedule
from detectinblur_tpu_torch.utils.convert import (
    classifier_from_torchvision,
    classifier_params_from_jax,
)

T = torch.from_numpy
SRC = (64, 96)            # source bucket of the test batches
BUCKET = (64, 96)         # model bucket: images shrink to fit it


def pair(num_classes=16, bn_mode="train", seed=0):
    """(JAX classifier, its variables, the port's) on one state dict."""
    sd = resnet18_sd(num_classes, seed)
    params, stats = convert_resnet_classifier_state_dict(sd, include_fc=True)
    jmodel = jax_cls.ResNetClassifier("resnet18", num_classes, bn_mode)
    model = cls.ResNetClassifier("resnet18", num_classes, bn_mode,
                                 precision="highest", device="cpu")
    model.load_state_dict(classifier_from_torchvision(
        sd, num_classes=num_classes, include_fc=True))
    return jmodel, {"params": params, "batch_stats": stats}, model


# ----------------------------------------------------------- label maps
BLUR = dict(blurring=np.array([True, True, False, True, True, True, True]),
            param_index=np.array([0, 2, -1, 1, 2, 1, 0], np.int32),
            fraction_index=np.array([0, 4, -1, -1, 3, 2, 4], np.int32))
BLUR["est_label"] = np.array([3, -1, 2, -1, -1, 0, -1], np.int32)
BLUR["pred"] = np.arange(16, dtype=np.int32)
MAPS = {
    "estimator_label": lambda m, b: m.estimator_label(
        b["blurring"], b["param_index"], b["fraction_index"]),
    "estimator_label_lehe": lambda m, b: m.estimator_label_lehe(
        b["blurring"], b["param_index"], b["fraction_index"], b["est_label"]),
    "estimator_to_model_index_16": lambda m, b: m.estimator_to_model_index_16(
        b["pred"]),
    "model_index_oracle": lambda m, b: m.model_index_oracle(
        b["blurring"], b["param_index"], b["fraction_index"]),
}


@pytest.mark.parametrize("name", sorted(MAPS))
def test_label_maps_match_jax(name):
    """Exact, over clean, negligible, low and high exposures and a stored
    LEHE label, and for every 16-class prediction."""
    ours = MAPS[name](cls, {k: T(v) for k, v in BLUR.items()})
    ref = MAPS[name](jax_cls, {k: jnp.asarray(v) for k, v in BLUR.items()})
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert ours.dtype == torch.int64


# -------------------------------------------------------- the classifier
@pytest.mark.parametrize("bn_mode", ["eval", "train"])
def test_classifier_logits_match_jax(bn_mode):
    """Logits within 1e-4 of their scale, in eval mode (running
    statistics) and train mode (batch statistics, whose running update
    must be JAX's within 1e-5 of each tensor's scale)."""
    jmodel, variables, model = pair(bn_mode=bn_mode)
    x = np.random.default_rng(5).standard_normal((2, 64, 96, 3)).astype(
        np.float32)
    if bn_mode == "train":
        ref, new = jmodel.apply(variables, jnp.asarray(x),
                                mutable=["batch_stats"])
        model.train()
    else:
        ref, new = jmodel.apply(variables, jnp.asarray(x)), None
    ours = model(T(x))
    ref = np.asarray(ref)
    assert ours.shape == (2, 16) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.detach().numpy(), ref,
                               atol=1e-4 * np.abs(ref).max(), rtol=0)
    if new is not None:
        want = classifier_params_from_jax(np_tree(variables["params"]),
                                          np_tree(new["batch_stats"]))
        for k, v in model.state_dict().items():
            r = want[k].numpy()
            np.testing.assert_allclose(v.numpy(), r, rtol=0,
                                       atol=1e-5 * max(np.abs(r).max(), 1),
                                       err_msg=k)


def test_classifier_converters_match_jax_and_are_strict():
    """``classifier_from_torchvision`` equals JAX's converter followed by
    ``classifier_params_from_jax``, bit for bit; without ``include_fc``
    the file's fc is skipped. Both raise on a missing key, an extra key
    and a wrong shape."""
    sd = resnet18_sd()
    params, stats = convert_resnet_classifier_state_dict(sd, include_fc=True)
    ref = classifier_params_from_jax(np_tree(params), np_tree(stats))
    ours = classifier_from_torchvision(sd, include_fc=True)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    trunk = classifier_from_torchvision(sd, num_classes=4)
    assert sorted(trunk) == sorted(k for k in ref if not k.startswith("fc"))
    cut = dict(sd)
    del cut["layer3.1.bn2.running_var"]
    with pytest.raises(KeyError, match="layer3.1.bn2.running_var"):
        classifier_from_torchvision(cut)
    with pytest.raises(KeyError, match="unused"):
        classifier_from_torchvision(dict(sd, **{"layer5.0.conv1.weight":
                                                np.zeros(1, np.float32)}))
    with pytest.raises(ValueError, match="shape"):
        classifier_from_torchvision(sd, include_fc=True, num_classes=4)
    jp, js = np_tree(params), np_tree(stats)
    del jp["body"]["layer2_0"]["downsample_0"]
    with pytest.raises(KeyError, match="downsample_0"):
        classifier_params_from_jax(jp, js)
    with pytest.raises(ValueError, match="shape"):
        classifier_params_from_jax(np_tree(params), js, num_classes=4)


def test_bn_affines_train_in_the_estimator_only():
    """The BatchNorm affines are parameters. The estimator trains them
    (every parameter gets a gradient); the detector's freeze mask keeps
    its trained set as it was: the BatchNorm affines are out of it whether
    they are buffers (FrozenBatchNorm) or parameters (a bn_mode), and the
    state-dict keys are the same in both."""
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
    )
    from detectinblur_tpu_torch.train.state import _freeze_mask

    _, _, model = pair()
    names = dict(model.named_parameters())
    assert "body.layer2_0.bn1.scale" in names and "body.bn1.bias" in names
    frozen = FasterRCNN(FasterRCNNConfig(), device="meta")
    train_bn = FasterRCNN(FasterRCNNConfig(bn_mode="train"), device="meta")
    want = {k for k, v in _freeze_mask(frozen).items() if v}
    mask = _freeze_mask(train_bn)
    got = {k for k, v in mask.items() if v}
    assert got == want and len(want) == 72
    assert not mask["backbone.body.layer3_2.bn3.scale"]
    assert not mask["backbone.body.layer2_0.downsample_1.bias"]
    assert mask["backbone.body.layer2_0.downsample_0.weight"]
    extra = {k for k in train_bn.state_dict()
             if k.rpartition(".")[2] in ("running_mean", "running_var",
                                         "num_batches_tracked")}
    assert set(train_bn.state_dict()) - extra == set(frozen.state_dict())


# ----------------------------------------------- resizes, crop and blur
def test_resizes_and_crop_match_jax():
    """``resize_valid`` (up and down), ``resize_into_bucket`` (a scale that
    overflows the bucket shrinks) and ``preprocess_batch(crop_images=
    True)`` against JAX's, within 1e-5 (3e-5 after the normalization,
    values up to 2.6); the sizes exact."""
    rng = np.random.default_rng(6)
    img = rng.random((48, 64, 3), np.float32)
    for hw, new in (((40, 50), (97, 121)), ((48, 64), (30, 41))):
        ours = dt.resize_valid(T(img), hw, new, (128, 128))
        ref = jax_dt.resize_valid(jnp.asarray(img), jnp.asarray(hw),
                                  jnp.asarray(new), (128, 128))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    for scale in (1.7, 3.1):
        ours, ours_hw = dt.resize_into_bucket(T(img), (45, 61), scale,
                                              (128, 160))
        ref, ref_hw = jax_dt.resize_into_bucket(
            jnp.asarray(img), jnp.array([45, 61]), jnp.float32(scale),
            (128, 160))
        assert ours_hw == tuple(np.asarray(ref_hw).tolist())
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    images = rng.random((3, 64, 96, 3), np.float32)
    hw = np.array([[64, 96], [56, 80], [40, 96]], np.int32)
    ours, ours_hw = dt.preprocess_batch(T(images), hw, (256, 320),
                                        crop_images=True)
    ref, ref_hw = jax_dt.preprocess_batch(jnp.asarray(images),
                                          jnp.asarray(hw), (256, 320),
                                          crop_images=True)
    np.testing.assert_array_equal(ours_hw.numpy(), np.asarray(ref_hw))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=3e-5)
    assert est.estimator_resize_canvas(480, 640) == \
        jax_est.estimator_resize_canvas(480, 640) == (1600, 1600)


def _batch(rng, B=2):
    """A blur batch on the 64x96 source bucket: image 0 blurred (type 1,
    exposure 3), image 1 clean and smaller."""
    images = np.zeros((B, *SRC, 3), np.float32)
    hw = np.array([[64, 96], [56, 80]][:B], np.int32)
    for b, (h, w) in enumerate(hw):
        images[b, :h, :w] = rng.random((h, w, 3))
    psfs = np.zeros((B, 128, 128), np.float32)
    psfs[:, 58:70, 60:66] = rng.random((B, 12, 6))
    fields = dict(hw=hw, psfs=psfs, blurring=np.array([True, False][:B]),
                  param_index=np.array([1, -1][:B], np.int32),
                  fraction_index=np.array([3, -1][:B], np.int32),
                  gt_boxes=np.zeros((B, 2, 4), np.float32),
                  gt_labels=np.zeros((B, 2), np.int64),
                  gt_valid=np.zeros((B, 2), bool),
                  est_label=np.full(B, -1, np.int32))
    ours = engine.BlurBatch(images=T(images), **{k: T(v)
                                                 for k, v in fields.items()})
    ref = jax_engine.BlurBatch(images=jnp.asarray(images), thetas=jnp.zeros(B),
                               lam1s=jnp.ones(B), lam2s=jnp.ones(B),
                               **{k: jnp.asarray(v) for k, v in fields.items()})
    return ours, ref


@pytest.mark.parametrize("resize_images", [False, True])
def test_blur_batch_images_matches_jax(resize_images):
    """The estimator's blur, at the image's size and through the
    min-side-800 round trip (a 1600x1600 canvas): within 1e-5; the clean
    image untouched."""
    ours_b, ref_b = _batch(np.random.default_rng(7))
    ours = est.blur_batch_images(ours_b, resize_images)
    ref = np.asarray(jax_est.blur_batch_images(ref_b, resize_images))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)
    assert torch.equal(ours[1], ours_b.images[1])
    assert (ours[0] - ours_b.images[0]).abs().max() > 1e-2


def test_quantize_matches_jax():
    """The 8-bit quantization step of the corruption chain: exact."""
    img = np.random.default_rng(8).random((2, 16, 16, 3), np.float32)
    ours = est.apply_corruptions(T(img), quantize=True)
    ref = jax_est.apply_corruptions(jax.random.key(0), jnp.asarray(img),
                                    quantize=True)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert not np.array_equal(ours.numpy(), img)


# ---------------------------------------------------------------- steps
LR, WD = 0.01, 1e-4


@pytest.fixture(scope="module")
def step_case():
    """One LEHE train step with label smoothing 0.1, every corruption
    (JAX's draws injected), --resize_images and --crop_images, from the
    same weights on both sides."""
    jmodel, variables, model = pair(num_classes=4, bn_mode="train", seed=1)
    ours_b, ref_b = _batch(np.random.default_rng(9))
    kw = dict(lehe=True, label_smoothing=0.1, add_noise=True,
              add_block=True, add_jpeg=True, quantize=True,
              resize_images=True, crop_images=True)
    tx = optax.chain(optax.add_decayed_weights(WD),
                     optax.sgd(jax_schedule(LR, 1, milestones=(6, 8)),
                               momentum=0.9))
    jstep = jax_est.make_estimator_train_step(jmodel, tx, BUCKET, **kw)
    params = variables["params"]
    # The JAX step donates its state and statistics: copy them first.
    start = classifier_params_from_jax(np_tree(params),
                                       np_tree(variables["batch_stats"]),
                                       num_classes=4)
    key = jax.random.key(11)
    jstate, jstats, jm = jstep(JaxTrainState(jnp.int32(0), params,
                                             tx.init(params)),
                               variables["batch_stats"], ref_b, key)
    draws = jax_corruption_draws(jax.random.split(key)[0],
                                 ours_b.images.shape)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9,
                          weight_decay=WD)
    step = est.make_estimator_train_step(
        model, make_lr_schedule(LR, 1, milestones=(6, 8)), BUCKET, **kw)
    state, metrics = step(TrainState(0, model, opt), ours_b,
                          corruption_draws=draws)
    ref = classifier_params_from_jax(np_tree(jstate.params),
                                     np_tree(jstats), num_classes=4)
    return {k: float(v) for k, v in jm.items()}, metrics, state, ref, start


def test_estimator_train_step_matches_jax(step_case):
    """Loss within 1e-5 relative, top-1 equal; each parameter's gradient
    (JAX's from its update: (p0 - p1) / lr - wd * p0) within 5e-2 of the
    tensor's largest magnitude and the median over tensors within 2e-3,
    as for the detector under batch statistics (few values a channel in
    layer4); the running statistics within 1e-5 of their scale, counts 1.
    Every parameter moved, the BatchNorm affines too."""
    jm, metrics, state, ref, start = step_case
    assert state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), jm["loss"], rtol=1e-5)
    assert metrics["top1"].item() == jm["top1"]
    errs = {}
    for name, p in state.model.named_parameters():
        p0 = start[name].numpy()
        g_ref = (p0 - ref[name].numpy()) / LR - WD * p0
        scale = np.abs(g_ref).max()
        assert scale > 0 and not torch.equal(p.detach(), start[name]), name
        errs[name] = np.abs(p.grad.numpy() - g_ref).max() / scale
    assert not {k: v for k, v in errs.items() if not v <= 5e-2}
    assert np.median(list(errs.values())) <= 2e-3
    for k, v in state.model.state_dict().items():
        if k.rpartition(".")[2] in ("running_mean", "running_var"):
            r = ref[k].numpy()
            np.testing.assert_allclose(v.numpy(), r, rtol=0,
                                       atol=1e-5 * max(np.abs(r).max(), 1),
                                       err_msg=k)
            assert not torch.equal(v, start[k]), k
        elif k.endswith("num_batches_tracked"):
            assert v.item() == ref[k].item() == 1.0


def test_estimator_eval_step_matches_jax():
    """16 classes, eval-mode BatchNorm: predictions, labels and top-2 hits
    equal JAX's; the running statistics are not touched."""
    jmodel, variables, model = pair(num_classes=16, bn_mode="train", seed=2)
    ours_b, ref_b = _batch(np.random.default_rng(10))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = est.make_estimator_eval_step(model, BUCKET)(ours_b)
    ref = jax_est.make_estimator_eval_step(jmodel, BUCKET)(
        variables, ref_b, jax.random.key(0))
    for k in ("pred", "label", "top2_hit"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(out["label"].numpy(), [9, 0])
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
