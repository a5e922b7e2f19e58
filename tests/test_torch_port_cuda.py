"""The port's CUDA kernels against their plain torch versions, its
evaluation CLI, and the remedy train and eval steps, on a card.

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
    roi_align_from_geometry,
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


@pytest.mark.gpu
def test_evaluate_cli_on_the_card(cuda, tmp_path):
    """The port's cli.evaluate on a small synthetic COCO, on the card
    (its default device): 19 stats, and roi_align_fwd launched once per
    image."""
    from synthetic_coco import write_coco

    import detectinblur_tpu_torch.cli.evaluate as cli_eval

    root = write_coco(str(tmp_path), {"val2017": [(120, 160), (160, 120),
                                                  (100, 150)]}, seed=0)
    before = roi_align_cuda.roi_align_fwd.launches
    stats = cli_eval.main(["--data-path", root, "--vanilla_eval"])
    torch.cuda.synchronize()
    assert roi_align_cuda.roi_align_fwd.launches == before + 3
    assert stats.shape == (19,) and np.isfinite(stats).all()


def _remedy_inputs():
    """Two small blurred images with GT, PSFs, blur indices, and the
    corruption draws, all on the CPU (numpy- and generator-seeded)."""
    from detectinblur_tpu_torch.ops.psf import sample_psf
    from detectinblur_tpu_torch.train.engine import BlurBatch
    from detectinblur_tpu_torch.train.estimator_engine import draw_corruptions

    rng = np.random.default_rng(6)
    gen = torch.Generator().manual_seed(6)
    imgs = torch.from_numpy(rng.random((2, 96, 128, 3), np.float32))
    gt = np.zeros((2, 4, 4), np.float32)
    gt[..., :2] = rng.uniform(0, 40, (2, 4, 2))
    gt[..., 2:] = gt[..., :2] + rng.uniform(10, 40, (2, 4, 2))
    batch = BlurBatch(
        images=imgs, hw=torch.tensor([[96, 128], [90, 110]]),
        psfs=sample_psf(2, 0.005, 0.5, iters=300, generator=gen, device="cpu"),
        blurring=torch.tensor([True, True]), gt_boxes=torch.from_numpy(gt),
        gt_labels=torch.from_numpy(rng.integers(1, 91, (2, 4))),
        gt_valid=torch.ones(2, 4, dtype=torch.bool),
        param_index=torch.tensor([0, 0], dtype=torch.int32),
        fraction_index=torch.tensor([3, 3], dtype=torch.int32))
    return batch, draw_corruptions(imgs, True, 0.001, True, True, gen)


REMEDY_CFG = dict(min_size=96, max_size=128, precision="highest",
                  warp_internally=True)


@pytest.mark.gpu
@pytest.mark.parametrize("bn_mode", [None, "train"])
def test_remedy_train_step_card_vs_cpu(cuda, bn_mode):
    """One train step with the warp, the norms, blur, noise and block (the
    same corruption draws; the RPN's prediction layers zeroed so both
    sample the same anchors and rois; the samplers' draws from one CPU
    generator), both kernels launched on the card: losses within 1e-4
    relative. With FrozenBatchNorm also the median over tensors of each
    gradient's error within 5e-3 of its max: the card rounds the warp's
    sample positions otherwise than the CPU, and a ReLU that such noise
    flips moves a coarse layer's gradient by up to a few percent, so no
    bound holds each tensor (chip_smoke.py phase 9c measures the spread).
    With BatchNorm on a from-scratch model's batch statistics the
    gradients are chaotic, and the losses alone are held."""
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
        LossDraws,
    )
    from detectinblur_tpu_torch.train.engine import make_train_step
    from detectinblur_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )

    batch, cdraws = _remedy_inputs()
    cfg = FasterRCNNConfig(bn_mode=bn_mode, **REMEDY_CFG)
    A = 3 * (24 * 32 + 12 * 16 + 6 * 8 + 3 * 4 + 2 * 2)
    PG = cfg.rpn.post_nms_top_n_train + 4
    gen = torch.Generator().manual_seed(7)
    draws = LossDraws(rpn=tuple(torch.rand(2, A, generator=gen) for _ in "ab"),
                      roi=tuple(torch.rand(2, PG, generator=gen) for _ in "ab"))
    out = {}
    for dev in ("cpu", "cuda"):
        model = FasterRCNN(cfg, device=dev, seed=0)
        with torch.no_grad():
            model.rpn_head.cls_logits.weight.zero_()
            model.rpn_head.bbox_pred.weight.zero_()
            model.rpn_head.bbox_pred.bias.zero_()
        opt, sched = make_optimizer(model, base_lr=0.02, steps_per_epoch=1)
        step = make_train_step(model, sched, (96, 128), use_warp=True,
                               use_custom_norm=True, add_noise=True,
                               add_block=True, expand_target_boxes=True)
        before = (roi_align_cuda.roi_align_fwd.launches,
                  roi_align_cuda.roi_align_bwd.launches)
        _, m = step(create_train_state(model, opt), batch,
                    draws=LossDraws(*(tuple(t.to(dev) for t in d)
                                      for d in draws)),
                    corruption_draws=cdraws)
        launched = (roi_align_cuda.roi_align_fwd.launches - before[0],
                    roi_align_cuda.roi_align_bwd.launches - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (1, 1))
        out[dev] = ({k: v.item() for k, v in m.items()},
                    {n: p.grad.cpu() for n, p in model.named_parameters()
                     if p.grad is not None})
    for k, v in out["cpu"][0].items():
        assert abs(out["cuda"][0][k] - v) <= 1e-4 * abs(v), k
    if bn_mode is None:
        errs = [(out["cuda"][1][n] - r).abs().max().item()
                / max(r.abs().max().item(), 1e-30)
                for n, r in out["cpu"][1].items()]
        assert np.median(errs) <= 5e-3


@pytest.mark.gpu
def test_remedy_eval_step_on_the_card(cuda):
    """The eval step with every eval-time remedy (dilation, blur, noise,
    block, JPEG, the warp, the norms, mode_one BatchNorm) on the card:
    one forward launch, finite detections, the BatchNorm statistics left
    as they were."""
    from detectinblur_tpu_torch.models.batchnorm import set_num_batches_tracked
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
    )
    from detectinblur_tpu_torch.train.engine import make_eval_step

    batch, cdraws = _remedy_inputs()
    model = FasterRCNN(FasterRCNNConfig(bn_mode="mode_one", **REMEDY_CFG),
                       device=cuda, seed=0)
    set_num_batches_tracked(model, 16.0)
    stats = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_eval_step(model, (96, 128), blur_eval=True,
                          expand_target_boxes=True, use_warp=True,
                          use_custom_norm=True, add_noise=True,
                          add_block=True, add_jpeg=True, dilate_psf=True)
    before = roi_align_cuda.roi_align_fwd.launches
    dets, gt = step(model, batch, torch.Generator(device=cuda).manual_seed(0),
                    corruption_draws=cdraws)
    torch.cuda.synchronize()
    assert roi_align_cuda.roi_align_fwd.launches == before + 1
    assert torch.isfinite(dets.boxes).all() and torch.isfinite(gt).all()
    assert all(torch.equal(v, stats[k]) for k, v in model.state_dict().items())


@pytest.mark.gpu
def test_deblur_card_vs_cpu(cuda):
    """Deblur-first's MSResNet (3 scales, 16 features, 4 blocks) on two
    odd-sized images, float32 with TF32 off on the card: within 1e-5 of
    the CPU on the 0..1 scale."""
    from synthetic_torch import synthetic_deepdeblur_state_dict

    from detectinblur_tpu_torch.models.deblur import MSResNet, deblur_image
    from detectinblur_tpu_torch.utils.convert import deepdeblur_from_torch

    sd = deepdeblur_from_torch(synthetic_deepdeblur_state_dict(
        n_scales=3, feats=16, n_blocks=4, seed=1))
    x = torch.rand(2, 75, 101, 3, generator=torch.Generator().manual_seed(0))
    cpu = deblur_image(MSResNet.from_state_dict(sd), x)
    card = deblur_image(MSResNet.from_state_dict(sd).to(cuda), x.to(cuda))
    assert card.shape == x.shape
    assert (card.cpu() - cpu).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_estimator_train_step_card_vs_cpu(cuda):
    """One LEHE estimator train step (label smoothing, noise and block
    with shared draws, the min-side-800 blur, the crop) on 2 x 64x96
    images in ``highest`` precision: the loss within 1e-4 relative of the
    CPU's, each gradient within 5e-2 of its tensor's largest magnitude
    (median 2e-3; BatchNorm on batch statistics), the running statistics
    within 1e-4. JPEG and the quantization are left out: they round the
    image values, and the float noise between cuFFT's blur and the CPU's
    flips some of their steps (a 1e-6 nudge moves the CPU's own loss by
    1.1e-4 and its gradients by up to 0.35 of a tensor's max with them,
    6e-5 without)."""
    from detectinblur_tpu_torch.models.classifier import ResNetClassifier
    from detectinblur_tpu_torch.ops.psf import sample_psf
    from detectinblur_tpu_torch.train.engine import BlurBatch
    from detectinblur_tpu_torch.train.estimator_engine import (
        draw_corruptions,
        make_estimator_train_step,
    )
    from detectinblur_tpu_torch.train.state import (
        TrainState,
        make_lr_schedule,
    )

    gen = torch.Generator().manual_seed(3)
    images = torch.rand(2, 64, 96, 3, generator=gen)
    batch = BlurBatch(
        images=images, hw=torch.tensor([[64, 96], [56, 80]]),
        psfs=sample_psf(2, expl=0.005, fraction=0.5, generator=gen,
                        device="cpu"),
        blurring=torch.tensor([True, False]),
        gt_boxes=torch.zeros(2, 1, 4),
        gt_labels=torch.zeros(2, 1, dtype=torch.int64),
        gt_valid=torch.zeros(2, 1, dtype=torch.bool),
        param_index=torch.tensor([2, -1], dtype=torch.int32),
        fraction_index=torch.tensor([4, -1], dtype=torch.int32),
        est_label=torch.full((2,), -1, dtype=torch.int32))
    draws = draw_corruptions(images, True, 0.001, True, False, gen)
    got = {}
    for dev in ("cpu", cuda):
        model = ResNetClassifier("resnet18", 4, precision="highest",
                                 device=dev, seed=5)
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9,
                              weight_decay=1e-4)
        step = make_estimator_train_step(
            model, make_lr_schedule(0.01, 1, milestones=(6, 8)), (64, 96),
            lehe=True, label_smoothing=0.1, add_noise=True, add_block=True,
            resize_images=True, crop_images=True)
        _, m = step(TrainState(0, model, opt), batch, corruption_draws=draws)
        got[str(dev)] = (m["loss"].item(),
                         {k: p.grad.cpu() for k, p in model.named_parameters()},
                         {k: v.cpu() for k, v in model.state_dict().items()
                          if k.endswith(("running_mean", "running_var"))})
    (lp, gp, sp), (lc, gc, sc) = got["cpu"], got["cuda"]
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    errs = [((gc[k] - gp[k]).abs().max() / gp[k].abs().max()).item()
            for k in gp]
    assert max(errs) <= 5e-2 and np.median(errs) <= 2e-3
    for k in sp:
        assert (sc[k] - sp[k]).abs().max() <= 1e-4 * max(
            sp[k].abs().max().item(), 1), k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [1280, 2048])
def test_single_level_kernels_match_plain(rng, cuda, dtype, channels):
    """The single-map detectors' pooling: both kernels on one stride-32
    map of MobileNetV2's 1280 or the ResNet-50 C5's 2048 channels (a
    26x34 map, the 832x1088 bucket's), every roi on level 0 at 1/32,
    against the plain versions on the same geometry. Forward as
    ``test_roi_align_kernel_matches_plain`` holds it; backward within 1e-5
    of the largest gradient, as ``test_roi_align_bwd_kernel_matches_plain``."""
    dt = getattr(torch, dtype)
    B, R, shape = 2, 200, (26, 34)
    feat = torch.from_numpy(rng.standard_normal(
        (B, *shape, channels), dtype=np.float32)).to(cuda, dt)
    boxes = np.zeros((B, R, 4), np.float32)
    boxes[..., :2] = rng.uniform(-40, 1000, (B, R, 2))
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(0.5, 600, (B, R, 2))
    boxes[:, :len(EDGE_ROIS)] = EDGE_ROIS
    boxes = torch.from_numpy(boxes).to(cuda)
    geom = roi_geometry(boxes.reshape(-1, 4), [shape], spatial_scale=1 / 32)
    assert int(geom.level.abs().sum()) == 0
    f = feat.clone().requires_grad_(True)
    before = (roi_align_cuda.roi_align_fwd.launches,
              roi_align_cuda.roi_align_bwd.launches)
    out = roi_align_cuda.roi_align_single_level_cuda(f, boxes, 1 / 32)
    dout = _dout(rng, B, R, channels, cuda, dt)
    out.backward(dout.reshape(out.shape))
    torch.cuda.synchronize()
    assert (roi_align_cuda.roi_align_fwd.launches,
            roi_align_cuda.roi_align_bwd.launches) == (before[0] + 1,
                                                       before[1] + 1)
    ref = roi_align_from_geometry([feat], geom, R).float()
    err = (out.detach().reshape(ref.shape).float() - ref).abs()
    scale = ref.abs().max().item()
    if dt == torch.float32:
        assert err.max().item() <= 1e-5 * scale
    else:
        got = out.detach().reshape(ref.shape).float()
        bound = 2 ** -7 * torch.maximum(got.abs(), ref.abs()) + 1e-5 * scale
        assert bool((err <= bound).all())
    gref, = roi_align_backward_from_geometry(dout, geom, R, [shape])
    grad = roi_align_cuda.roi_align_bwd(dout, geom, R, [shape])[0]
    assert (grad - gref).abs().max().item() <= 1e-5 * gref.abs().max().item()
    assert f.grad.dtype == dt and f.grad.shape == feat.shape


@pytest.mark.gpu
def test_profiling_on_the_card(rng, cuda, tmp_path):
    """``utils/profiling.py`` on CUDA: ``step_timer`` waits for the card,
    ``device_memory_stats`` reads the allocator and the card's memory,
    and ``trace`` records the hand-written RoIAlign forward kernel,
    launched through ctypes, by name."""
    import json

    from detectinblur_tpu_torch.utils.profiling import (
        device_memory_stats,
        step_timer,
        trace,
    )

    feats, boxes = _inputs(rng)
    feats = [torch.from_numpy(f).to(cuda) for f in feats]
    boxes = torch.from_numpy(boxes).to(cuda)
    multiscale_roi_align_cuda = roi_align_cuda.multiscale_roi_align_cuda
    multiscale_roi_align_cuda(feats, boxes)          # build, warm up
    a = torch.randn(4096, 4096, device=cuda)
    with step_timer(sync=cuda) as t:
        for _ in range(20):
            a = a @ a / 64.0
    # 20 products of 2 x 4096^3 operations take milliseconds on any card;
    # timed without the wait, the block returns in microseconds.
    assert t.seconds > 1e-3
    torch.cuda.reset_peak_memory_stats(cuda)
    stats = device_memory_stats(cuda)
    assert set(stats) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    assert 0 < stats["bytes_in_use"] <= stats["peak_bytes_in_use"]
    assert stats["bytes_limit"] == torch.cuda.get_device_properties(
        cuda).total_memory
    assert device_memory_stats() == device_memory_stats(cuda)
    with trace(str(tmp_path / "trace")):
        out = multiscale_roi_align_cuda(feats, boxes)
        torch.cuda.synchronize()
    assert out.shape[:2] == boxes.shape[:2]
    events = json.load(open(tmp_path / "trace" / "trace.json"))["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("roi_align_fwd_kernel" in k for k in kernels), kernels[:20]
