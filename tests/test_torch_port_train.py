"""The port's training slice held against the JAX package on the CPU: the
box helpers of the GT expansion, the RPN and roi samplers and losses, the
optimizer recipe, ``FasterRCNN.loss`` with its gradients, and two whole
train steps, in ``highest`` precision.

Random draws: both sides sample with the same uniforms. Where the JAX
function takes a key, the port gets the uniforms that key yields
(``_jax_draws``); where the test picks the uniforms itself (ties), the JAX
side reads them through a patched ``jax.random.uniform``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_reference import make_random_fasterrcnn_sd
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

from detectinblur_tpu.models import roi_heads as jax_roi_heads
from detectinblur_tpu.models import rpn as jax_rpn
from detectinblur_tpu.models.anchors import grid_anchors
from detectinblur_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from detectinblur_tpu.models.faster_rcnn import (
    FasterRCNNConfig as JaxFasterRCNNConfig,
)
from detectinblur_tpu.models.roi_heads import BoxHeadConfig as JaxBoxHeadConfig
from detectinblur_tpu.models.rpn import RPNConfig as JaxRPNConfig
from detectinblur_tpu.ops import boxes as jax_boxes
from detectinblur_tpu.train import engine as jax_engine
from detectinblur_tpu.train import state as jax_state
from detectinblur_tpu.utils.torch_convert import convert_fasterrcnn_state_dict
from detectinblur_tpu_torch.models import roi_heads, rpn
from detectinblur_tpu_torch.models.faster_rcnn import (
    FasterRCNN,
    FasterRCNNConfig,
    LossDraws,
)
from detectinblur_tpu_torch.models.roi_heads import BoxHeadConfig
from detectinblur_tpu_torch.models.rpn import RPNConfig
from detectinblur_tpu_torch.ops import boxes
from detectinblur_tpu_torch.train import engine, state
from detectinblur_tpu_torch.utils.convert import params_from_jax

T = torch.from_numpy


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rand_boxes(rng, shape, lo=0.0, hi=100.0, min_wh=1.0, max_wh=40.0):
    b = np.zeros(shape + (4,), np.float32)
    b[..., :2] = rng.uniform(lo, hi, shape + (2,))
    b[..., 2:] = b[..., :2] + rng.uniform(min_wh, max_wh, shape + (2,))
    return b


def _uniform_pair(key, n):
    """The two uniform vectors ``balanced_sample`` draws from ``key``."""
    kp, kn = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kp, (n,))),
            np.asarray(jax.random.uniform(kn, (n,))))


def _jax_draws(key, B, A, PG):
    """The draws of ``FasterRCNN.loss(key)``: keys split (B, 2), column 0
    for the RPN sampler over A anchors, column 1 for the roi sampler over
    P + G candidates."""
    keys = jax.random.split(key, (B, 2))
    rpn_d = [_uniform_pair(keys[b, 0], A) for b in range(B)]
    roi_d = [_uniform_pair(keys[b, 1], PG) for b in range(B)]

    def stack(pairs, i):
        return T(np.stack([p[i] for p in pairs]))

    return LossDraws(rpn=(stack(rpn_d, 0), stack(rpn_d, 1)),
                     roi=(stack(roi_d, 0), stack(roi_d, 1)))


@pytest.fixture
def feed_uniforms(monkeypatch):
    """Make the JAX sampler read the given uniforms, in call order."""
    def feed(arrays):
        queue = list(arrays)
        monkeypatch.setattr(jax.random, "uniform",
                            lambda key, shape: jnp.asarray(queue.pop(0)))
    return feed


# -------------------------------------------------------------- boxes
def test_encode_boxes_matches_jax(rng):
    """The same float32 formula; XLA fuses multiply-adds and its log may
    differ by an ulp, so a few results differ in the last bit: 1e-6."""
    ref, prop = _rand_boxes(rng, (50,)), _rand_boxes(rng, (50,))
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        np.testing.assert_allclose(
            boxes.encode_boxes(T(ref), T(prop), w).numpy(),
            np.asarray(jax_boxes.encode_boxes(ref, prop, w)),
            rtol=1e-6, atol=1e-6)


def test_fix_box_squeeze_matches_jax_exactly(rng):
    b = _rand_boxes(rng, (60,), lo=-30, hi=130, min_wh=-5, max_wh=20)
    b[:5, 2] = b[:5, 0]            # zero width
    b[5:10, 3] = b[5:10, 1] - 3    # inverted height
    np.testing.assert_array_equal(
        boxes.fix_box_squeeze(T(b), 90, 110).numpy(),
        np.asarray(jax_boxes.fix_box_squeeze(b, 90, 110)))


def test_expand_boxes_by_psf_matches_jax_exactly(rng):
    """Per image: support extents of the PSF around (63, 63), the squeeze
    fix against that image's size, passthrough when not blurring."""
    B, G = 3, 7
    b = _rand_boxes(rng, (B, G), lo=-5, hi=100)
    psfs = np.zeros((B, 128, 128), np.float32)
    psfs[0, 50:70, 58:90] = rng.random((20, 32))
    psfs[1, 63, 63] = 1.0
    psfs[2, 10:20, 100:120] = rng.random((10, 20))
    blurring = np.array([True, True, False])
    hw = np.array([[96, 120], [110, 100], [80, 80]], np.int32)
    ours = boxes.expand_boxes_by_psf(T(b), T(psfs), T(blurring),
                                     T(hw[:, 0]), T(hw[:, 1]))
    for i in range(B):
        ref = jax_boxes.expand_boxes_by_psf(b[i], psfs[i], blurring[i],
                                            hw[i, 0], hw[i, 1])
        np.testing.assert_array_equal(ours[i].numpy(), np.asarray(ref))


# ---------------------------------------------------------------- RPN
def _anchors(shapes=((16, 20), (8, 10), (4, 5), (2, 3), (1, 2))):
    return np.concatenate(grid_anchors(shapes, (64, 80)))


def test_assign_targets_to_anchors_matches_jax_exactly(rng):
    """Labels and matched indices identical, a GT-less image included."""
    anchors = _anchors()
    B, G = 3, 6
    gt = _rand_boxes(rng, (B, G), hi=70, min_wh=4, max_wh=50)
    valid = rng.random((B, G)) > 0.3
    valid[1] = False
    labels, matches = rpn.assign_targets_to_anchors(
        T(anchors), T(gt), T(valid), 0.7, 0.3)
    for b in range(B):
        rl, rm = jax_rpn.assign_targets_to_anchors(anchors, gt[b], valid[b],
                                                   0.7, 0.3)
        np.testing.assert_array_equal(labels[b].numpy(), np.asarray(rl))
        np.testing.assert_array_equal(matches[b].numpy(), np.asarray(rm))
    assert (labels[1] == 0).all() and (labels[0] == 1).any()


@pytest.mark.parametrize("tied", [False, True])
def test_balanced_sample_matches_jax_exactly(rng, feed_uniforms, tied):
    """The same uniforms give the same masks; quantised uniforms collide
    and exercise the tie order (lower index first, as top_k)."""
    A = 3000
    labels = rng.choice([-1, 0, 1], size=A, p=[0.2, 0.7, 0.1])
    u = rng.random((2, A), dtype=np.float32)
    if tied:
        u = np.floor(u * 40) / 40
    feed_uniforms([u[0], u[1]])
    rp, rn = jax_rpn.balanced_sample(jax.random.key(0), jnp.asarray(labels),
                                     256, 0.5)
    pos, neg = rpn.balanced_sample(T(labels), 256, 0.5,
                                   draws=(T(u[0]), T(u[1])))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(rn))
    assert pos.sum() == 128 and neg.sum() == 128


def test_rpn_loss_and_grads_match_jax(rng):
    """Draws from the JAX keys; sums within 1e-5 relative, gradients with
    respect to objectness and deltas within 1e-5 of their max (float32
    sums in another order)."""
    anchors = _anchors()
    A, B, G = anchors.shape[0], 2, 5
    obj = rng.normal(0, 2, (B, A)).astype(np.float32)
    dlt = rng.normal(0, 0.3, (B, A, 4)).astype(np.float32)
    gt = _rand_boxes(rng, (B, G), hi=60, min_wh=8, max_wh=40)
    valid = np.ones((B, G), bool)
    valid[0, -1] = False
    cfg = JaxRPNConfig()
    keys = jax.random.split(jax.random.key(3), B)

    def jax_total(o, d):
        out = [jax_rpn.rpn_loss(keys[b], o[b], d[b], anchors, gt[b], valid[b],
                                cfg) for b in range(B)]
        return sum(bl + ol for bl, ol, _ in out), out

    (_, ref), (go, gd) = jax.value_and_grad(jax_total, argnums=(0, 1),
                                            has_aux=True)(obj, dlt)
    draws = [_uniform_pair(keys[b], A) for b in range(B)]
    o, d = T(obj).requires_grad_(), T(dlt).requires_grad_()
    box_l, obj_l, n = rpn.rpn_loss(
        o, d, T(anchors), T(gt), T(valid), RPNConfig(),
        draws=tuple(T(np.stack([p[i] for p in draws])) for i in range(2)))
    (box_l + obj_l).sum().backward()
    for b in range(B):
        np.testing.assert_allclose(box_l[b].item(), float(ref[b][0]), rtol=1e-5)
        np.testing.assert_allclose(obj_l[b].item(), float(ref[b][1]), rtol=1e-5)
        assert n[b].item() == int(ref[b][2]) == 256
    for g, r in ((o.grad, go), (d.grad, gd)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * np.abs(r).max())


def test_run_rpn_training_uses_train_sizes_and_detaches():
    """``training`` picks the train top-k and the proposals carry no
    graph while objectness and deltas do."""
    head = rpn.RPNHead(in_channels=8)
    head.reset_parameters(torch.Generator().manual_seed(0))
    feats = [torch.randn(1, h, w, 8, generator=torch.Generator().manual_seed(h))
             for h, w in ((16, 20), (8, 10), (4, 5), (2, 3), (1, 2))]
    cfg = RPNConfig(pre_nms_top_n_train=300, post_nms_top_n_train=50,
                    pre_nms_top_n_test=100, post_nms_top_n_test=20)
    hw = torch.tensor([[64, 80]])
    out = rpn.run_rpn(head, feats, hw, cfg, training=True)
    assert out.proposals.shape == (1, 50, 4)
    assert not out.proposals.requires_grad
    assert out.objectness.requires_grad and out.pred_deltas.requires_grad
    assert rpn.run_rpn(head, feats, hw, cfg).proposals.shape == (1, 20, 4)


# ---------------------------------------------------------- roi heads
def test_select_training_samples_matches_jax(rng):
    """Same draws: identical sampled slots, labels and validity; targets
    to 1e-5 (log may differ by an ulp)."""
    B, P, G = 2, 300, 6
    props = _rand_boxes(rng, (B, P), hi=90, min_wh=3, max_wh=60)
    pvalid = rng.random((B, P)) > 0.1
    gt = _rand_boxes(rng, (B, G), hi=80, min_wh=10, max_wh=50)
    gl = rng.integers(1, 91, (B, G)).astype(np.int32)
    gv = np.ones((B, G), bool)
    gv[1, 4:] = False
    cfg = JaxBoxHeadConfig(batch_size_per_image=128)
    keys = jax.random.split(jax.random.key(5), B)
    draws = [_uniform_pair(keys[b], P + G) for b in range(B)]
    ours = roi_heads.select_training_samples(
        T(props), T(pvalid), T(gt), T(gl), T(gv),
        BoxHeadConfig(batch_size_per_image=128),
        draws=tuple(T(np.stack([d[i] for d in draws])) for i in range(2)))
    for b in range(B):
        ref = jax_roi_heads.select_training_samples(
            keys[b], props[b], pvalid[b], gt[b], gl[b], gv[b], cfg)
        valid = np.asarray(ref[3])
        assert valid.sum() == 128 and (np.asarray(ref[1]) > 0).sum() > 5
        np.testing.assert_array_equal(ours[3][b].numpy(), valid)
        np.testing.assert_array_equal(ours[1][b].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(ours[0][b].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(ours[2][b].numpy()[valid],
                                   np.asarray(ref[2])[valid],
                                   rtol=1e-5, atol=1e-5)


def test_fastrcnn_loss_and_grads_match_jax(rng):
    """Sums within 1e-5 relative; gradients within 1e-5 of their max."""
    B, S, C = 2, 40, 6
    logits = rng.normal(0, 2, (B, S, C)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (B, S, C * 4)).astype(np.float32)
    labels = rng.integers(-1, C, (B, S)).astype(np.int32)
    targets = rng.normal(0, 0.5, (B, S, 4)).astype(np.float32)

    def jax_total(lg, dl):
        out = [jax_roi_heads.fastrcnn_loss(lg[b], dl[b], labels[b], targets[b])
               for b in range(B)]
        return sum(c + x for c, x, _ in out), out

    (_, ref), (gl, gd) = jax.value_and_grad(jax_total, argnums=(0, 1),
                                            has_aux=True)(logits, deltas)
    lg, dl = T(logits).requires_grad_(), T(deltas).requires_grad_()
    ce, bx, n = roi_heads.fastrcnn_loss(lg, dl, T(labels), T(targets))
    (ce + bx).sum().backward()
    for b in range(B):
        np.testing.assert_allclose(ce[b].item(), float(ref[b][0]), rtol=1e-5)
        np.testing.assert_allclose(bx[b].item(), float(ref[b][1]), rtol=1e-5)
        assert n[b].item() == int(ref[b][2])
    for g, r in ((lg.grad, gl), (dl.grad, gd)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * np.abs(r).max())


def test_losses_give_no_nan_gradient_on_degenerate_targets():
    """A padded (zero-size) GT encodes to -inf targets in slots that hold
    no positive; those slots are masked before smooth_l1."""
    anchors = T(_anchors())
    A = anchors.shape[0]
    obj = torch.zeros(1, A, requires_grad=True)
    dlt = torch.zeros(1, A, 4, requires_grad=True)
    box_l, obj_l, _ = rpn.rpn_loss(obj, dlt, anchors, torch.zeros(1, 2, 4),
                                   torch.zeros(1, 2, dtype=torch.bool),
                                   RPNConfig(),
                                   generator=torch.Generator().manual_seed(0))
    (box_l + obj_l).sum().backward()
    assert torch.isfinite(dlt.grad).all() and torch.isfinite(obj.grad).all()
    logits = torch.zeros(1, 3, 4, requires_grad=True)
    deltas = torch.zeros(1, 3, 16, requires_grad=True)
    targets = torch.tensor([[[0.0, 0, -np.inf, -np.inf], [0.1, 0, 0, 0],
                             [np.nan] * 4]])
    ce, bx, _ = roi_heads.fastrcnn_loss(logits, deltas,
                                        torch.tensor([[0, 2, -1]]), targets)
    (ce + bx).sum().backward()
    assert torch.isfinite(deltas.grad).all() and torch.isfinite(bx).all()


# -------------------------------------------------------- train state
@pytest.mark.parametrize("steps_per_epoch", [1000, 50, 2, 1])
def test_lr_schedule_matches_jax(steps_per_epoch):
    """Warmup and MultiStep decay, float32 in both: 1e-6 relative."""
    ours = state.make_lr_schedule(0.04, steps_per_epoch)
    ref = jax_state.make_lr_schedule(0.04, steps_per_epoch)
    steps = list(range(0, 1101)) + [m * steps_per_epoch + d for m in (16, 22)
                                     for d in (-1, 0, 1)]
    got = np.array([ours(s) for s in steps])
    np.testing.assert_allclose(got, np.asarray(jax.vmap(ref)(jnp.array(steps))),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def jax_tree():
    return convert_fasterrcnn_state_dict(
        make_random_fasterrcnn_sd(np.random.default_rng(0)))


@pytest.mark.parametrize("layers", [3, 5, 0])
def test_freeze_mask_matches_jax(jax_tree, layers):
    """Every port parameter is trainable exactly when its JAX leaf is; the
    JAX leaves without a port parameter are the FrozenBN affines (buffers
    here), which JAX freezes too."""
    model = FasterRCNN(FasterRCNNConfig(precision="highest"), device="meta")
    ours = state._freeze_mask(model, layers)
    # The mask as leaves shaped like the params, so params_from_jax maps it.
    ref = params_from_jax(jax.tree.map(
        lambda m, p: np.full(np.shape(p), m, np.float32),
        jax_state._freeze_mask(jax_tree, layers), _np_tree(jax_tree)))
    ref = {k: bool(v.flatten()[0]) for k, v in ref.items()}
    assert set(ours) <= set(ref)
    for name, trainable in ours.items():
        assert trainable == ref[name], name
    for name in set(ref) - set(ours):
        assert name in dict(model.named_buffers()) and not ref[name], name
    if layers == 3:
        assert not ours["backbone.body.layer1_2.conv3.weight"]
        assert ours["backbone.body.layer2_0.conv1.weight"]


def test_sgd_matches_optax_every_step(rng):
    """torch SGD (momentum, weight decay, lr set per step) against
    ``add_decayed_weights`` + ``optax.sgd(momentum)`` with the same
    schedule over 4 steps, the first one included: 1e-6 relative."""
    sched = state.make_lr_schedule(0.04, 3)
    p0 = rng.normal(0, 1, (5, 7)).astype(np.float32)
    grads = [rng.normal(0, 1, (5, 7)).astype(np.float32) for _ in range(4)]
    tx = optax.chain(optax.add_decayed_weights(1e-4),
                     optax.sgd(jax_state.make_lr_schedule(0.04, 3),
                               momentum=0.9))
    jp, opt_state = jnp.asarray(p0), None
    opt_state = tx.init(jp)
    p = torch.nn.Parameter(T(p0.copy()))
    opt = torch.optim.SGD([p], lr=sched(0), momentum=0.9, weight_decay=1e-4)
    for i, g in enumerate(grads):
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = T(g)
        opt.param_groups[0]["lr"] = sched(i)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)


def test_make_optimizer_freezes_and_trains():
    model = FasterRCNN(FasterRCNNConfig(precision="highest"), device="cpu")
    opt, sched = state.make_optimizer(model, base_lr=0.04, steps_per_epoch=10)
    trainable = {id(p) for g in opt.param_groups for p in g["params"]}
    mask = state._freeze_mask(model)
    for name, p in model.named_parameters():
        assert (id(p) in trainable) == mask[name] == p.requires_grad, name
    assert opt.param_groups[0]["lr"] == pytest.approx(4e-5)
    assert sched(9) == pytest.approx(0.04, rel=1e-6)


def test_train_step_refuses_unported_options():
    """Every option of the train and eval steps is ported and builds a
    step, deblur-first (an eval step's ``deblurrer``) included; nothing is
    refused any more."""
    from detectinblur_tpu_torch.models.deblur import MSResNet

    model = FasterRCNN(FasterRCNNConfig(precision="highest"), device="meta")
    for kw in ("use_warp", "use_custom_norm", "add_noise", "add_block",
               "add_jpeg"):
        assert callable(engine.make_train_step(model, lambda s: 0.0, (64, 64),
                                               **{kw: True}))
        assert callable(engine.make_eval_step(model, (64, 64), **{kw: True}))
    assert callable(engine.make_eval_step(model, (64, 64), dilate_psf=True))
    with torch.device("meta"):
        net = MSResNet(n_scales=2, feats=4, n_blocks=1)
    assert callable(engine.make_eval_step(model, (64, 64), deblurrer=net))


def test_images01_matches_jax():
    img = np.arange(2 * 3 * 4 * 3, dtype=np.uint8).reshape(2, 3, 4, 3)
    batch = engine.BlurBatch(T(img), *([None] * 6))
    ref = jax_engine.images01(jax_engine.BlurBatch(
        jnp.asarray(img), *([None] * 11)))
    np.testing.assert_array_equal(engine.images01(batch).images.numpy(),
                                  np.asarray(ref.images))
    f = batch._replace(images=T(img.astype(np.float32)))
    assert engine.images01(f).images is f.images


# ------------------------------------------------ the loss as a whole
BUCKET = (128, 160)
HW = np.array([[110, 150], [128, 100]], np.int32)


def _model_pair(sd, jcfg, tcfg):
    jparams = convert_fasterrcnn_state_dict(sd)
    model = FasterRCNN(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(_np_tree(jparams)))
    return JaxFasterRCNN(jcfg), jparams, model


def _gt(rng, B, G, hw):
    gt = np.zeros((B, G, 4), np.float32)
    for b, (h, w) in enumerate(hw):
        gt[b] = _rand_boxes(rng, (G,), hi=min(h, w) * 0.6, min_wh=10,
                            max_wh=min(h, w) * 0.5)
    labels = rng.integers(1, 91, (B, G)).astype(np.int32)
    valid = np.ones((B, G), bool)
    valid[0, -1] = False
    return gt, labels, valid


def _grad_errors(model, jgrads):
    """Per port parameter: (max |port - JAX| / max |JAX|, max |JAX|) of the
    gradient; a gradient that is zero in JAX must be zero in the port."""
    ref = params_from_jax(_np_tree(jgrads))
    out = {}
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        diff = np.abs(p.grad.numpy() - r).max()
        scale = np.abs(r).max()
        out[name] = (diff / scale if scale else (np.inf if diff else 0.0),
                     scale)
    return out


@pytest.fixture(scope="module")
def loss_case():
    """Full ResNet50-FPN at the 128x160 bucket, default RPN and box
    configs. The RPN's cls_logits and bbox_pred weights are zero, so every
    anchor's objectness is its anchor type's bias and its deltas are zero
    in both frameworks, bit for bit: the top-k, NMS and both samplers then
    see identical inputs, and the comparison is not at the mercy of
    near-tied scores that float noise through fifty layers would reorder
    (tests/test_torch_port_model.py shows that noise)."""
    sd = make_random_fasterrcnn_sd(np.random.default_rng(0))
    sd["rpn.head.cls_logits.weight"][:] = 0
    sd["rpn.head.cls_logits.bias"][:] = [0.3, -0.2, 0.1]
    sd["rpn.head.bbox_pred.weight"][:] = 0
    sd["rpn.head.bbox_pred.bias"][:] = 0
    jcfg = JaxFasterRCNNConfig(min_size=BUCKET[0], max_size=BUCKET[1])
    tcfg = FasterRCNNConfig(min_size=BUCKET[0], max_size=BUCKET[1],
                            precision="highest")
    jmodel, jparams, model = _model_pair(sd, jcfg, tcfg)
    rng = np.random.default_rng(4)
    images = rng.random((2, 128, 160, 3), dtype=np.float32)
    gt, gl, gv = _gt(rng, 2, 5, HW)
    key = jax.random.key(7)

    def total(p):
        losses, _ = jmodel.loss(p, key, jnp.asarray(images), jnp.asarray(HW),
                                gt, gl, gv, bucket=BUCKET)
        return sum(losses.values()), losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jparams)
    A = sum(f.shape[0] for f in grid_anchors(
        ((32, 40), (16, 20), (8, 10), (4, 5), (2, 3)), BUCKET))
    draws = _jax_draws(key, 2, A, jcfg.rpn.post_nms_top_n_train + 5)
    losses = model.loss(T(images), HW, T(gt), T(gl), T(gv), BUCKET,
                        draws=draws)
    sum(losses.values()).backward()
    return ({k: float(v) for k, v in jlosses.items()}, jgrads, losses, model)


def test_loss_matches_jax(loss_case):
    """The four losses within 1e-4 relative: identical sampled anchors and
    rois, features that differ by float32 summation order (the backbone
    test holds them to 2e-3 of each level's max; here they are far
    closer)."""
    jlosses, _, losses, _ = loss_case
    assert list(losses) == list(jlosses) or set(losses) == set(jlosses)
    for k, v in jlosses.items():
        assert np.isfinite(v) and v > 0, k
        np.testing.assert_allclose(losses[k].item(), v, rtol=1e-4, err_msg=k)


def test_loss_gradients_match_jax(loss_case):
    """Every parameter's gradient against JAX's, relative to its largest
    magnitude: the median over tensors within 5e-4 and each within 1e-2.
    The gradients are float32 sums through fifty layers in another order
    (the RoIAlign backward scatters with index_add_ here, the take-VJP
    there), and float noise in the activations flips a few ReLU decisions,
    which weighs most on the top block's 4x5 map (layer4_2.conv3 lands near
    5e-3). A gradient that is zero in JAX (no roi on P4/P5 at this bucket;
    the RPN conv behind zeroed prediction layers) is zero here."""
    _, jgrads, _, model = loss_case
    errs = _grad_errors(model, jgrads)
    assert len(errs) == len(list(model.parameters()))
    bad = {k: v for k, v in errs.items() if not v[0] <= 1e-2}
    assert not bad, bad
    assert np.median([e for e, _ in errs.values()]) <= 5e-4
    assert errs["backbone.body.layer2_0.conv1.weight"][1] > 0
    assert errs["rpn_head.cls_logits.weight"][1] > 0
    assert errs["rpn_head.conv.weight"][1] == 0


# ----------------------------------------------------- two train steps
STEP_BUCKET = (64, 64)
STEP_HW = np.array([[64, 64], [56, 60]], np.int32)


@pytest.fixture(scope="module")
def step_case():
    """Two make_train_step steps (blur, GT expansion, loss, backward, SGD
    with warmup then momentum) on both sides, full ResNet50-FPN at the
    64x64 bucket with random weights everywhere, the RPN's included.

    The configuration keeps every anchor as a proposal (NMS at IoU 1.0
    suppresses nothing, top-k sizes cover all 1023 anchors) and samples
    every candidate roi (budget 1040): after the first update the two
    sides' objectness differs by float noise, which may reorder proposals
    but, so configured, cannot change which rois the loss sums over."""
    sd = make_random_fasterrcnn_sd(np.random.default_rng(1))
    rpn_kw = dict(pre_nms_top_n_train=1000, post_nms_top_n_train=1023,
                  nms_thresh=1.0)
    box_kw = dict(batch_size_per_image=1040, positive_fraction=0.5)
    jcfg = JaxFasterRCNNConfig(min_size=64, max_size=64,
                               rpn=JaxRPNConfig(**rpn_kw),
                               box=JaxBoxHeadConfig(**box_kw))
    tcfg = FasterRCNNConfig(min_size=64, max_size=64, rpn=RPNConfig(**rpn_kw),
                            box=BoxHeadConfig(**box_kw), precision="highest")
    jmodel, jparams, model = _model_pair(sd, jcfg, tcfg)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}

    rng = np.random.default_rng(6)
    G = 4
    images = rng.random((2, 64, 64, 3), dtype=np.float32)
    psfs = np.zeros((2, 128, 128), np.float32)
    psfs[:, 58:70, 60:67] = rng.random((2, 12, 7))
    gt, gl, gv = _gt(rng, 2, G, STEP_HW)
    batch = dict(hw=STEP_HW, psfs=psfs, blurring=np.array([True, False]),
                 gt_boxes=gt, gt_labels=gl, gt_valid=gv)

    # steps_per_epoch 2: warmup over 1 step, so lr 4e-5 then 0.04.
    tx, _ = jax_state.make_optimizer(base_lr=0.04, steps_per_epoch=2,
                                     params=jparams)
    jstep = jax_engine.make_train_step(jmodel, tx, STEP_BUCKET,
                                       blur_train=True,
                                       expand_target_boxes=True)
    jbatch = jax_engine.BlurBatch(
        images=jnp.asarray(images), thetas=None, lam1s=None, lam2s=None,
        param_index=None, fraction_index=None,
        **{k: jnp.asarray(v) for k, v in batch.items()})
    jst = jax_state.create_train_state(jax.tree.map(jnp.array, jparams), tx)
    keys = [jax.random.key(11), jax.random.key(12)]
    jmetrics = []
    for k in keys:
        jst, m = jstep(jst, jbatch, k)
        jmetrics.append({n: float(v) for n, v in m.items()})

    opt, sched = state.make_optimizer(model, base_lr=0.04, steps_per_epoch=2)
    step = engine.make_train_step(model, sched, STEP_BUCKET, blur_train=True,
                                  expand_target_boxes=True)
    st = state.create_train_state(model, opt)
    tbatch = engine.BlurBatch(images=T(images),
                              **{k: T(v) for k, v in batch.items()})
    A, PG = 1023, 1023 + G
    metrics = []
    for k in keys:
        draws = _jax_draws(jax.random.split(k)[0], 2, A, PG)
        st, m = step(st, tbatch, draws=draws)
        metrics.append({n: v.item() for n, v in m.items()})
    return jmetrics, jst.params, metrics, model, p0


def test_two_train_steps_losses_match_jax(step_case):
    """Both steps' losses within 1e-4 relative (the second step's model is
    the first step's update on each side)."""
    jmetrics, _, metrics, _, _ = step_case
    for jm, m in zip(jmetrics, metrics):
        for k, v in jm.items():
            assert np.isfinite(v), k
            np.testing.assert_allclose(m[k], v, rtol=1e-4, err_msg=k)


def test_two_train_steps_params_match_jax(step_case):
    """The update of every parameter over two steps, port against JAX,
    within 2e-3 of the largest update of that tensor (gradient noise as in
    the loss test, carried through momentum); frozen ones unchanged."""
    _, jparams, _, model, p0 = step_case
    ref = params_from_jax(_np_tree(jparams))
    mask = state._freeze_mask(model)
    for name, p in model.named_parameters():
        upd = (p.detach() - p0[name]).numpy()
        ref_upd = ref[name].numpy() - p0[name].numpy()
        if not mask[name]:
            assert not upd.any() and not ref_upd.any(), name
            continue
        scale = np.abs(ref_upd).max()
        assert scale > 0, name
        err = np.abs(upd - ref_upd).max() / scale
        assert err <= 2e-3, (name, err)
