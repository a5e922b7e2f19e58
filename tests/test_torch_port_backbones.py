"""The single-map detectors (``--model mobile_net|resnet_50``) held
against the JAX package on the CPU, ``highest`` precision: each torso
(MobileNetV2 at full width on 64x96, the resnet18 and resnet50 trunks,
vgg11), ``SingleMapFasterRCNN.predict`` and ``loss`` with its gradients
and BatchNorm update on JAX's ``tests/test_backbones.py`` tiny
configuration (JAX's draws injected), the plain single-level RoIAlign and
its VJP, the torso converters, the freeze mask (the set of tensors a step
moves) and the CLIs' model bucket for these detectors (a fault of the
reference, mirrored)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remedy_helpers import jax_loss_draws, match, np_tree
from synthetic_torch import (
    synthetic_mobilenet_v2_state_dict,
    synthetic_resnet_state_dict,
)
from torso_weights import mobilenet_sd, resnet_sd

from detectinblur_tpu.data.batching import (
    model_bucket_for_batch as jax_model_bucket_for_batch,
)
from detectinblur_tpu.models import backbones as jb
from detectinblur_tpu.models.resnet import ResNet as JaxResNet
from detectinblur_tpu.models.roi_heads import BoxHeadConfig as JaxBoxHeadConfig
from detectinblur_tpu.models.rpn import RPNConfig as JaxRPNConfig
from detectinblur_tpu.ops.roi_align import (
    roi_align_single_level as jax_roi_align_single_level,
)
from detectinblur_tpu.train import state as jax_state
from detectinblur_tpu.utils.torch_convert import (
    convert_mobilenet_v2_features,
    convert_resnet_trunk_state_dict,
)
from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
from detectinblur_tpu_torch.models.backbones import (
    SingleMapConfig,
    SingleMapFasterRCNN,
)
from detectinblur_tpu_torch.models.roi_heads import BoxHeadConfig
from detectinblur_tpu_torch.models.rpn import RPNConfig
from detectinblur_tpu_torch.ops.roi_align import roi_align_single_level
from detectinblur_tpu_torch.ops.roi_align_cuda import roi_align_single_level_cuda
from detectinblur_tpu_torch.train.state import make_optimizer
from detectinblur_tpu_torch.utils.convert import (
    params_from_jax,
    torso_from_torchvision,
)

T = torch.from_numpy
# JAX tests/test_backbones.py's tiny_cfg: min 96 / max 128, small pools.
RPN_KW = dict(pre_nms_top_n_train=200, post_nms_top_n_train=100,
              pre_nms_top_n_test=200, post_nms_top_n_test=100)
BOX_KW = dict(batch_size_per_image=64, nms_pool=256, detections_per_img=20)
BUCKET = (96, 128)
HW = np.array([[96, 128], [80, 100]], np.int32)
N_CLASSES = 5


def _rel(ours, ref):
    r = np.asarray(ref, np.float32)
    return np.abs(np.asarray(ours, np.float32) - r).max() / np.abs(r).max()


# ----------------------------------------------------------------- torsos
@pytest.mark.parametrize("arch,mode", [("mobile_net", "eval"),
                                       ("mobile_net", "train"),
                                       ("resnet18", None),
                                       ("resnet50", None)])
def test_torso_matches_jax(arch, mode):
    """The port's torso on a torchvision ImageNet dict (converted by
    ``torso_from_torchvision``) against JAX's torso on JAX's conversion of
    the same dict, 2 x 64x96: MobileNetV2 at full width with eval-mode
    BatchNorm (the dict's running statistics) and train-mode (batch
    statistics), the resnet18 and resnet50 trunks' C5 with FrozenBatchNorm
    folded at eps 0; within 1e-4 of the map's largest magnitude (float32
    sums in other orders through 18-53 convolutions), 5e-4 on batch
    statistics (the head's cover 12 values a channel: 2 images of 2x3,
    so float noise weighs a twelfth of a channel's statistics; measured
    1.4e-4)."""
    x = np.random.default_rng(1).random((2, 64, 96, 3), np.float32)
    if arch == "mobile_net":
        sd = mobilenet_sd()
        params, stats = convert_mobilenet_v2_features(sd)
        jtorso = jb.MobileNetV2Features(bn_mode=mode)
        ref = jax.jit(lambda p, s, x: jtorso.apply(
            {"params": p, "batch_stats": s}, x, mutable=["batch_stats"])[0])(
                params, stats, jnp.asarray(x))
        cfg = SingleMapConfig(arch, bn_mode=mode, precision="highest")
    else:
        sd = resnet_sd(arch)
        params, _ = convert_resnet_trunk_state_dict(sd, arch=arch)
        jtorso = JaxResNet(arch)
        ref = jax.jit(lambda p, x: jtorso.apply({"params": p}, x)[-1])(
            params, jnp.asarray(x))
        cfg = SingleMapConfig(arch, precision="highest")
    model = SingleMapFasterRCNN(cfg, device="cpu")
    model.load_state_dict({**model.state_dict(),
                           **torso_from_torchvision(sd, arch)})
    with torch.no_grad():
        ours, = model.features(T(x))
    assert ours.shape == ref.shape
    assert _rel(ours, ref) <= (5e-4 if mode == "train" else 1e-4)


def test_vgg11_torso_matches_jax():
    """vgg11 (not a CLI choice; ``SingleMapConfig`` takes it), JAX's own
    initialisation carried over by ``params_from_jax``: the map within
    1e-5 of its largest magnitude."""
    x = np.random.default_rng(2).random((1, 64, 96, 3), np.float32)
    jtorso = jb.VGGFeatures("vgg11")
    params = np_tree(jtorso.init(jax.random.key(0), jnp.asarray(x))["params"])
    ref = jax.jit(lambda p, x: jtorso.apply({"params": p}, x))(
        params, jnp.asarray(x))
    model = SingleMapFasterRCNN(SingleMapConfig("vgg11", precision="highest"),
                                device="cpu")
    model.load_state_dict(params_from_jax(
        {"backbone": params, **_heads_tree(model)}, backbone="vgg11"))
    assert not model.has_bn
    with torch.no_grad():
        ours, = model.features(T(x))
    assert _rel(ours, ref) <= 1e-5


# ------------------------------------------------------ predict and loss
@pytest.fixture(scope="module")
def jax_inits():
    """JAX's init of the tiny detector per torso, made once for the
    module (Flax's init runs op by op, seconds for MobileNetV2); ``_pair``
    hands out copies."""
    return {}


def _pair(arch, inits, zero_rpn=False):
    """(JAX model, params, bn_stats, port model) on the tiny config, 5
    classes: the heads from JAX's init (the predictor scaled x4, so that
    random weights score above the 0.05 threshold), the torso from a
    He-scaled torchvision dict. With ``zero_rpn`` the RPN's prediction
    layers are zero, so the proposals are the anchors in both frameworks
    and both samplers see identical inputs."""
    common = dict(num_classes=N_CLASSES, min_size=BUCKET[0],
                  max_size=BUCKET[1])
    jmodel = jb.SingleMapFasterRCNN(jb.SingleMapConfig(
        arch, rpn=JaxRPNConfig(**RPN_KW), box=JaxBoxHeadConfig(**BOX_KW),
        **common))
    if arch not in inits:
        inits[arch] = jmodel.init(jax.random.key(0), bucket=BUCKET)
    params = jax.tree.map(np.array, inits[arch])
    if arch == "mobile_net":
        params["backbone"], stats = np_tree(
            convert_mobilenet_v2_features(mobilenet_sd()))
        stats = {"backbone": stats}
    else:
        params["backbone"] = np_tree(convert_resnet_trunk_state_dict(
            resnet_sd(arch), arch=arch)[0])
        stats = None
    for k in ("cls_score", "bbox_pred"):
        params["box_predictor"][k]["kernel"] *= 4
    if zero_rpn:
        rpn = params["rpn_head"]
        rpn["cls_logits"]["kernel"][:] = 0
        # Away from 0, where the BCE's kink takes another subgradient in
        # each framework.
        rpn["cls_logits"]["bias"][:] = np.linspace(-0.3, 0.3, 15) + 0.01
        rpn["bbox_pred"]["kernel"][:] = 0
        rpn["bbox_pred"]["bias"][:] = 0
    model = SingleMapFasterRCNN(SingleMapConfig(
        arch, rpn=RPNConfig(**RPN_KW), box=BoxHeadConfig(**BOX_KW),
        precision="highest", **common), device="cpu")
    model.load_state_dict(params_from_jax(params, N_CLASSES, stats,
                                          backbone=arch))
    return jmodel, params, stats, model


def test_predict_matches_jax(jax_inits):
    """MobileNetV2's predict on 2 images (one 80x100 in the 96x128
    bucket), the torso on running statistics: 85% of JAX's valid
    detections matched per image by label, IoU > 0.95 and score within
    2e-3 (``remedy_helpers.match``), and the running statistics left as
    they were. The resnet torso's eval forward is held by
    ``test_torso_matches_jax`` and the rest of its path by the loss."""
    jmodel, params, stats, model = _pair("mobile_net", jax_inits)
    images = np.random.default_rng(3).random((2, *BUCKET, 3), np.float32)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    dets = model.predict(T(images), HW, BUCKET)
    ref = jax.jit(lambda p: jmodel.predict(
        p, jnp.asarray(images), jnp.asarray(HW), bucket=BUCKET,
        bn_stats=stats))(params)
    assert int(np.asarray(ref.valid).sum(1).min()) > 3
    shares = match(dets, ref)
    assert min(shares) > 0.85, shares
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def _gt(rng, B=2, G=3):
    gt = np.zeros((B, G, 4), np.float32)
    gt[..., :2] = rng.uniform(0, 50, (B, G, 2))
    gt[..., 2:] = gt[..., :2] + rng.uniform(20, 60, (B, G, 2))
    labels = rng.integers(1, N_CLASSES, (B, G)).astype(np.int32)
    valid = np.ones((B, G), bool)
    valid[1, -1] = False
    return gt, labels, valid


@pytest.fixture(scope="module", params=["mobile_net", "resnet18"])
def loss_case(request, jax_inits):
    """Both sides' loss, gradients and BatchNorm update on 2 images with
    3 and 2 GT boxes, JAX's key and the port fed its draws; ``grads_at``
    reruns the port's loss on other images from the same weights and
    statistics."""
    arch = request.param
    jmodel, params, stats, model = _pair(arch, jax_inits, zero_rpn=True)
    rng = np.random.default_rng(8)
    images = rng.random((2, *BUCKET, 3), np.float32)
    gt, gl, gv = _gt(rng)
    key = jax.random.key(9)

    def total(p):
        losses, new = jmodel.loss(p, key, jnp.asarray(images), jnp.asarray(HW),
                                  gt, gl, gv, bucket=BUCKET, bn_stats=stats)
        return sum(losses.values()), (losses, new)

    (_, (jlosses, jstats)), jgrads = jax.jit(
        jax.value_and_grad(total, has_aux=True))(params)
    A = 15 * (BUCKET[0] // 32) * (BUCKET[1] // 32)
    draws = jax_loss_draws(key, 2, A, RPN_KW["post_nms_top_n_train"] + 3)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def run(imgs):
        model.load_state_dict(start)
        model.zero_grad()
        losses = model.loss(T(imgs), HW, T(gt), T(gl), T(gv), BUCKET,
                            draws=draws)
        sum(losses.values()).backward()
        return losses

    def grads_at(imgs):
        after = {k: v.clone() for k, v in model.state_dict().items()}
        run(imgs)
        out = {n: p.grad.clone() for n, p in model.named_parameters()}
        model.load_state_dict(after)
        return out

    losses = run(images)
    return SimpleNamespace(
        arch=arch, jlosses={k: float(v) for k, v in jlosses.items()},
        jgrads=np_tree(jgrads),
        jstats=None if jstats is None else np_tree(jstats), params=params,
        losses=losses, grads={n: p.grad.clone()
                              for n, p in model.named_parameters()},
        model=model, images=images, grads_at=grads_at)


def test_loss_matches_jax(loss_case):
    """The four losses within 1e-4 relative."""
    for k, v in loss_case.jlosses.items():
        assert np.isfinite(v) and v > 0, k
        np.testing.assert_allclose(loss_case.losses[k].item(), v, rtol=1e-4,
                                   err_msg=k)


def test_loss_gradients_match_jax(loss_case):
    """Every parameter's gradient against JAX's, each tensor's error over
    its largest magnitude (floored at 1e-5 of the model's largest
    gradient: the BatchNorm betas ahead of a BatchNorm on batch statistics
    get gradients that are zero but for float noise). resnet18
    (FrozenBatchNorm affines training): within 1e-5 (measured 1.5e-6).

    MobileNetV2 on batch statistics is ill-conditioned at every size
    tried, and more images or larger inputs do not cure it: a nudge of
    the images by 1e-8, which float32 mostly rounds away, moves the
    port's own gradients by up to 13-20% (median 1.2-1.4%). Its limits
    are fixed, from the readings against JAX at 2 x 96x128, 4 x 192x256
    and 2 x 320x416 (``tests/gradient_conditioning.py``): every tensor
    within 0.25 (measured at most 0.184, 0.197, 0.170), the heads' within
    5e-2 (1.8e-2, 2.0e-2, 3.4e-2), the whole gradient within 2e-2 in L2
    (1.03e-2, 7.3e-3, 7.5e-3), the median tensor within 2e-2 (1.8e-2 at
    this size); and each tensor within 3x the port's own spread under a
    1e-6 nudge, or within 1e-3."""
    c = loss_case
    model = c.model
    ref = params_from_jax(c.jgrads, N_CLASSES,
                          _zero_stats(model) if model.has_bn else None,
                          backbone=c.arch)
    assert c.grads.keys() == {k for k in ref if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    top = max(r.abs().max().item() for r in ref.values())

    def errs(got, want):
        return {n: (g - want[n]).abs().max().item()
                / max(ref[n].abs().max().item(), 1e-5 * top)
                for n, g in got.items()}

    err = errs(c.grads, ref)
    worst = max(err.items(), key=lambda x: x[1])
    if not model.has_bn:
        assert worst[1] <= 1e-5, worst
        return
    assert worst[1] <= 0.25, worst
    heads = {n: e for n, e in err.items() if not n.startswith("backbone.")}
    assert max(heads.values()) <= 5e-2, heads
    l2 = (sum(float(((c.grads[n] - ref[n]).double() ** 2).sum())
              for n in c.grads)
          / sum(float((ref[n].double() ** 2).sum()) for n in c.grads)) ** 0.5
    assert l2 <= 2e-2, l2
    assert np.median(list(err.values())) <= 2e-2
    nudged = c.images + np.float32(1e-6) * np.random.default_rng(0) \
        .standard_normal(c.images.shape).astype(np.float32)
    spread = errs(c.grads_at(nudged), c.grads)
    bad = {n: (e, spread[n]) for n, e in err.items()
           if not e <= max(3 * spread[n], 1e-3)}
    assert not bad, bad


def _zero_stats(model):
    """A batch_stats tree of the right keys (the gradients have none)."""
    tree = {}
    for k in model.state_dict():
        head, _, leaf = k.rpartition(".")
        if leaf in ("running_mean", "running_var", "num_batches_tracked"):
            node = tree
            for part in head.split("."):
                node = node.setdefault(part, {})
            node[{"running_mean": "mean", "running_var": "var"}.get(
                leaf, leaf)] = np.zeros(model.state_dict()[k].shape,
                                        np.float32)
    return tree


def test_loss_updates_mobilenet_statistics_as_jax(loss_case):
    """MobileNetV2's running statistics after the loss, JAX's
    ``new_bn_stats``: within 1e-4 of each tensor's magnitude (E[x^2] - m^2
    over as few as 24 values a channel; measured 2.2e-5), every count 1. The resnet18 torso (FrozenBatchNorm) has none and JAX returns
    None."""
    arch, jstats, model = loss_case.arch, loss_case.jstats, loss_case.model
    params = loss_case.params
    if arch != "mobile_net":
        assert jstats is None and not model.has_bn
        return
    ref = params_from_jax(params, N_CLASSES, jstats, backbone=arch)
    n = 0
    for k, v in model.state_dict().items():
        if k.rpartition(".")[2] in ("running_mean", "running_var",
                                    "num_batches_tracked"):
            r = ref[k].numpy()
            np.testing.assert_allclose(v.numpy(), r,
                                       atol=1e-4 * max(np.abs(r).max(), 1),
                                       err_msg=k)
            n += 1
    assert n == 3 * 52
    assert model.backbone.stem_bn.num_batches_tracked.item() == 1.0


# ------------------------------------------------------- single RoIAlign
def test_roi_align_single_level_and_vjp_match_jax():
    """The plain single-level RoIAlign (every roi on the one level at
    1/32: no level mapping) and the autograd Function's CPU backward
    against JAX's ``roi_align_single_level`` and its VJP on a 9x13 map of
    64 channels, rois inside, past the edge, slivers and zeroed: within
    1e-5 of the largest magnitude. Chunks as JAX's: 1280 channels give 15
    rois a chunk."""
    from detectinblur_tpu_torch.ops.roi_align import single_level_chunk

    rng = np.random.default_rng(4)
    feat = rng.standard_normal((2, 9, 13, 64)).astype(np.float32)
    boxes = np.zeros((2, 40, 4), np.float32)
    boxes[..., :2] = rng.uniform(-60, 380, (2, 40, 2))
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(0.5, 300, (2, 40, 2))
    boxes[:, -4:] = 0.0
    cot = rng.standard_normal((2, 40, 7, 7, 64)).astype(np.float32)
    scale = 1.0 / 32

    def jax_fn(f):
        return jax.vmap(lambda fi, bi: jax_roi_align_single_level(
            fi, bi, scale))(f, jnp.asarray(boxes))

    ref, ref_grad = jax.jit(lambda f, c: (
        jax_fn(f), jax.vjp(jax_fn, f)[1](c)[0]))(jnp.asarray(feat),
                                                 jnp.asarray(cot))
    ours = torch.stack([roi_align_single_level(T(feat[b]), T(boxes[b]), scale)
                        for b in range(2)])
    assert _rel(ours, ref) <= 1e-5
    f = T(feat).requires_grad_(True)
    out = roi_align_single_level_cuda(f, T(boxes), scale)
    assert torch.equal(out.detach(), ours)
    out.backward(T(cot))
    assert _rel(f.grad, ref_grad) <= 1e-5
    assert single_level_chunk(1280, 1000) == 15


# ------------------------------------------------------------ converters
@pytest.mark.parametrize("arch,frozen", [("mobile_net", False),
                                         ("resnet50", True),
                                         ("resnet50", False)])
def test_torso_converter_equals_jax_route(arch, frozen):
    """``torso_from_torchvision`` bit for bit what JAX's converter plus
    ``params_from_jax`` give (MobileNetV2's statistics with a count of 16,
    as ``cli.evaluate`` sets; the resnet folded at eps 0, or unfolded);
    strict on a missing or an extra key."""
    if arch == "mobile_net":
        sd = synthetic_mobilenet_v2_state_dict(seed=3)
        params, stats = convert_mobilenet_v2_features(sd)
        stats = jax.tree.map(lambda x: np.full_like(x, 16.0)
                             if x.ndim == 0 else x, np_tree(stats))
    else:
        sd = synthetic_resnet_state_dict(arch, seed=3)
        params, stats = convert_resnet_trunk_state_dict(
            sd, arch=arch, frozen_bn=frozen, num_batches=16.0)
    ours = torso_from_torchvision(sd, arch, frozen_bn=frozen, num_batches=16.0)
    model = SingleMapFasterRCNN(SingleMapConfig(
        arch, bn_mode=None if frozen else "eval", precision="highest"),
        device="cpu")
    full = {"backbone": np_tree(params)}
    full.update(_heads_tree(model))
    ref = params_from_jax(full, batch_stats=None if stats is None else
                          {"backbone": np_tree(stats)}, backbone=arch)
    assert ours.keys() == {k for k in ref if k.startswith("backbone.")}
    for k, v in ours.items():
        assert v.dtype == torch.float32 and torch.equal(v, ref[k]), k
    cut = dict(sd)
    del cut[next(k for k in sd if k.endswith("running_var"))]
    with pytest.raises(KeyError):
        torso_from_torchvision(cut, arch, frozen_bn=frozen)
    with pytest.raises(KeyError, match="unused"):
        torso_from_torchvision(dict(sd, stray=np.zeros(3, np.float32)), arch,
                               frozen_bn=frozen)


def _heads_tree(model):
    """The port's heads as a JAX-layout tree (kernels transposed back)."""
    tree = {}
    for k, v in model.state_dict().items():
        if k.startswith("backbone."):
            continue
        head, _, leaf = k.rpartition(".")
        a = v.numpy()
        if leaf == "weight":
            leaf, a = "kernel", (np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4
                                 else a.T)
        node = tree
        for part in head.split("."):
            node = node.setdefault(part, {})
        node[leaf] = a
    return tree


@pytest.fixture(scope="module")
def jax_resnet18():
    """JAX's resnet18 single-map detector and its init, 91 classes."""
    jmodel = jb.SingleMapFasterRCNN(jb.SingleMapConfig("resnet18"))
    return jmodel, jmodel.init(jax.random.key(0), bucket=(64, 64))


def test_params_from_jax_single_map_is_strict(jax_resnet18):
    """The JAX tree of a resnet18 single-map model maps onto the port's
    (RPN conv 512 -> 256, fc6 from 512 x 7 x 7); a missing leaf or a
    class count that differs raises."""
    params = jax.tree.map(np.array, jax_resnet18[1])
    sd = params_from_jax(params, backbone="resnet18")
    assert sd["rpn_head.conv.weight"].shape == (256, 512, 3, 3)
    assert sd["box_head.fc6.weight"].shape == (1024, 512 * 49)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(params, num_classes=5, backbone="resnet18")
    del params["rpn_head"]["conv"]["bias"]
    with pytest.raises(KeyError, match="rpn_head.conv.bias"):
        params_from_jax(params, backbone="resnet18")


# ------------------------------------------------------ freeze mask (2)
def test_single_map_step_moves_the_tensors_jax_moves(jax_resnet18):
    """Trouble spot 2: JAX's freeze mask looks only under
    ``backbone.body``, so a single-map resnet torso trains whole, its
    FrozenBatchNorm affines included (parameters there). One SGD step of
    each optimizer on unit gradients moves the same set of tensors: every
    parameter of the port's model (the affines are parameters here too),
    none of its buffers."""
    params = jax_resnet18[1]
    tx, _ = jax_state.make_optimizer(base_lr=0.1, steps_per_epoch=10,
                                     params=params)
    updates, _ = jax.jit(tx.update)(jax.tree.map(jnp.ones_like, params),
                                    tx.init(params), params)
    flat = {".".join(str(k.key) for k in path): bool(jnp.any(u != 0))
            for path, u in jax.tree_util.tree_flatten_with_path(updates)[0]}
    jax_moved = {(k[:-len(".kernel")] + ".weight") if k.endswith(".kernel")
                 else k for k, v in flat.items() if v}
    assert any(".bn1.scale" in k for k in jax_moved)

    model = SingleMapFasterRCNN(SingleMapConfig("resnet18",
                                                precision="highest"),
                                device="cpu")
    opt, schedule = make_optimizer(model, base_lr=0.1, steps_per_epoch=10)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    for g in opt.param_groups:
        g["lr"] = schedule(0)
    opt.step()
    ours = {k for k, v in model.state_dict().items()
            if not torch.equal(v, before[k])}
    assert ours == jax_moved == {n for n, _ in model.named_parameters()}


# --------------------------------------------------- model bucket (1)
def test_cli_bucket_pads_the_single_map_as_jax():
    """Trouble spot 1, a fault of the reference mirrored: the CLIs size a
    single-map model's bucket with the FPN's 800/1333 (JAX
    ``cli/evaluate.py:158``, ``cli/train.py:192``), but the model resizes
    to 300/500 inside it. A 480x640 image becomes 300x400 in an 832x1088
    canvas: a 26x34 map with 13,260 anchors, of which the 10x13 cells over
    the image hold 1,950; the RPN ranks all of them."""
    hw = np.array([[480, 640]])
    bucket = model_bucket_for_batch(hw)
    assert bucket == tuple(jax_model_bucket_for_batch(hw)) == (832, 1088)
    model = SingleMapFasterRCNN(SingleMapConfig(precision="highest"),
                                device="cpu")
    images = torch.zeros(1, *bucket, 3)
    batched, new_hw = model.preprocess(images, hw, bucket)
    assert new_hw.tolist() == [[300, 400]]
    fmap = torch.zeros(1, bucket[0] // 32, bucket[1] // 32, 1)
    anchors, per_level = model.level_anchors([fmap])
    assert per_level == (13260,) and fmap.shape[1:3] == (26, 34)
    cy = (anchors[:, 1] + anchors[:, 3]) / 2
    cx = (anchors[:, 0] + anchors[:, 2]) / 2
    on_image = (cy < 300) & (cx < 400)
    assert int(on_image.sum()) == 1950
