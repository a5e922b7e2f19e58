"""Drive the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. Require CUDA; print the card's name and power limit.
  2. Build every kernel of the paths from the sources in the checkout (one
     nvcc per source, in parallel); print ptxas's registers and spills.
  3. Hold each kernel against its plain torch version: the RoIAlign
     forward at the serving shapes (8 images x 1000 rois on the 832x1088
     bucket's P2..P5), the backward at the train shapes (8 x 512 rois),
     float32 and bfloat16, on rois that include anchors, overlapping rois,
     slivers, boxes past the image edge, giants clamped to P5, zeroed
     invalid slots and (backward) rois with an all-zero cotangent.
  4. Serving, with bench.py's protocol: 8 random 480x640 images,
     camera-shake PSFs (expl 0.005, fraction 0.5) sampled once, blur, then
     Faster R-CNN ResNet50-FPN predict at full width in throughput
     (``default``) precision with the RPN delta head zeroed. Check the
     outputs, prove the path launched the forward kernel, time it (img/s
     and ms per stage with CUDA events).
  5. Training, with bench_train.py's protocol: the same batch shape with
     16 random GT boxes per image, blur and PSF-driven GT expansion, then
     the loss, backward and SGD (lr 0.04, 1000 steps per epoch, warmup) of
     a model trained from scratch, ``default`` precision. Prove the step
     launched both kernels, check the losses and which parameters moved,
     time it (img/s, ms per stage, peak memory).
  6. Time each kernel on its path's own inputs beside its plain version
     and its bound (the forward on the serving and the train rois), and
     count the unique cells each roi touches: the backward issues one
     float2 reduction per touched cell and pair of channels, where a
     reduction per sample corner would be 784 per roi and channel; the
     forward gathers 784 corner cells per roi, and a separable form would
     read only the touched ones. Also count the rois whose samples span at
     most 10 rows, the only ones on which a separable row walk beat the
     direct gather on the card.
  7. Hold the card's predict and the card's loss and gradients
     (``highest`` precision, kernels) against the port's CPU (plain
     versions) on a small input.

The last two lines are a JSON object describing each kernel and
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B, SRC_HW, C = 8, (480, 640), 256
TRAIN_R, TRAIN_G = 512, 16     # rois sampled and GT boxes per train image
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores


def _cuda_ms(fn, n):
    """Mean device ms of ``fn`` over ``n`` calls after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _check_rois(gen, level_shapes, bucket):
    """[B, 1000, 4] rois covering every roi class the kernel must get
    right, on the host."""
    from detectinblur_tpu_torch.models.anchors import grid_anchors

    H, W = bucket
    h5, w5 = level_shapes[-1]
    p2_to_p6 = tuple(level_shapes) + (((h5 + 1) // 2, (w5 + 1) // 2),)
    anchors = torch.from_numpy(np.concatenate(grid_anchors(p2_to_p6, bucket)))

    def u(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen)

    rois = []
    for _ in range(B):
        pick = anchors[torch.randint(len(anchors), (600,), generator=gen)]
        x, y = u(100, 0, W), u(100, 0, H)
        tall = torch.stack([x, y, x + u(100, 1, 8), y + u(100, 200, 800)], 1)
        x, y = u(100, 0, W), u(100, 0, H)
        wide = torch.stack([x, y, x + u(100, 200, 900), y + u(100, 1, 8)], 1)
        x, y = u(60, -300, W), u(60, -300, H)
        past = torch.stack([x, y, x + u(60, 300, 900), y + u(60, 300, 900)], 1)
        giant = torch.stack([u(40, -50, 50), u(40, -50, 50), u(40, 2000, 4000),
                             u(40, 2000, 4000)], 1)
        zeroed = torch.zeros(100, 4)
        rois.append(torch.cat([pick, tall, wide, past, giant, zeroed]))
    return torch.stack(rois)


def check_kernels(bucket, gen):
    from detectinblur_tpu_torch.ops.roi_align import multiscale_roi_align
    from detectinblur_tpu_torch.ops.roi_align_cuda import (
        multiscale_roi_align_cuda,
    )

    shapes = [(bucket[0] // s, bucket[1] // s) for s in (4, 8, 16, 32)]
    feats32 = [torch.randn(B, h, w, C, generator=gen).cuda()
               for h, w in shapes]
    rois = _check_rois(gen, shapes, bucket).cuda()
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        feats = [f.to(dt) for f in feats32]
        got = multiscale_roi_align_cuda(feats, rois).float()
        ref = multiscale_roi_align(feats, rois).float()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        scale = ref.abs().max().item()
        if dt == torch.float32:
            # Same samples and weights, float32 sums reassociated.
            tol = 1e-5 * scale
            ok = err.max().item() <= tol
            rule = f"max_abs_err <= 1e-5 * max|plain| = {tol:.3g}"
        else:
            # Both round one float32 sum to bf16; reassociation can flip
            # that rounding by one bf16 ulp (<= 2^-7 relative).
            bound = 2 ** -7 * torch.maximum(got.abs(), ref.abs()) + 1e-5 * scale
            ok = bool((err <= bound).all())
            rule = "|k - p| <= 2^-7 max(|k|,|p|) + 1e-5 max|plain|"
        print(f"roi_align_fwd {str(dt).split('.')[-1]} at {tuple(rois.shape)} "
              f"rois: max_abs_err {err.max().item():.3g} (max|plain| "
              f"{scale:.3g}), tolerance {rule}: {'ok' if ok else 'FAILED'}")
        if not ok:
            sys.exit("roi_align_fwd disagrees with its plain version")
        out[dt] = err.max().item()
    return out


def roi_align_bound(feats, g, R):
    """(bound ms, bound_by, bytes, ops, unique cells) for the RoIAlign
    kernel on these inputs (geometry table ``g``, ``R`` rois per image):
    each output element written once, each feature cell that some sample's
    corner needs (nonzero weight) read once, the geometry table read once;
    16 multiply-adds per output element."""
    N = g.level.shape[0]
    cells, _ = _touched(g, R, [f.shape[1:3] for f in feats])
    elem = feats[0].element_size()
    out_bytes = N * 49 * C * elem
    geom_bytes = sum(t.numel() * t.element_size() for t in g)
    nbytes = out_bytes + cells * C * elem + geom_bytes
    ops = N * 49 * C * 16 * 2
    return (*_bound(nbytes, ops), nbytes, ops, cells)


def check_bwd_kernel(bucket, gen):
    """roi_align_bwd against the plain backward at the train shapes, float32
    and bfloat16 cotangents; returns the max error per cotangent dtype."""
    from detectinblur_tpu_torch.ops.roi_align import (
        roi_align_backward_from_geometry,
        roi_geometry,
    )
    from detectinblur_tpu_torch.ops.roi_align_cuda import roi_align_bwd

    shapes = [(bucket[0] // s, bucket[1] // s) for s in (4, 8, 16, 32)]
    rois = _check_rois(gen, shapes, bucket)
    rois = rois[:, torch.randperm(rois.shape[1], generator=gen)[:TRAIN_R]]
    # Overlapping pairs: a quarter of the rois shifted by a pixel or two.
    rois[:, :TRAIN_R // 4] = rois[:, TRAIN_R // 4:TRAIN_R // 2] + 1.5
    geom = roi_geometry(rois.reshape(-1, 4).cuda(), shapes)
    dout32 = torch.randn(B * TRAIN_R, 7, 7, C, generator=gen)
    dout32[::9] = 0.0   # all-zero cotangents: the unsampled slots
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        dout = dout32.to(dt).cuda()
        got = roi_align_bwd(dout, geom, TRAIN_R, shapes)
        ref = roi_align_backward_from_geometry(dout, geom, TRAIN_R, shapes)
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        scale = max(r.abs().max().item() for r in ref)
        # Same products of the same (dtype-rounded) cotangent and weights;
        # only the order of the float32 sums differs (atomics).
        ok = err <= 1e-5 * scale
        print(f"roi_align_bwd {str(dt).split('.')[-1]} cotangent at "
              f"{B} x {TRAIN_R} rois: max_abs_err {err:.3g} (max|plain grad| "
              f"{scale:.3g}), tolerance max_abs_err <= 1e-5 * max|plain| = "
              f"{1e-5 * scale:.3g}: {'ok' if ok else 'FAILED'}")
        if not ok:
            sys.exit("roi_align_bwd disagrees with its plain version")
        out[dt] = err
    # The same call as on the train path, on these spread-out rois: beside
    # the train step's own rois (time_bwd_kernel) it shows how much of the
    # kernel's time is atomics contending for shared cells.
    ms = _cuda_ms(lambda: roi_align_bwd(dout, geom, TRAIN_R, shapes,
                                        torch.bfloat16), 20)
    bound_ms, _, nbytes, _, cells = roi_align_bwd_bound(
        dout, geom, TRAIN_R, shapes, torch.bfloat16)
    print(f"roi_align_bwd bfloat16 on these check rois ({cells} unique "
          f"feature cells): {ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes} bytes)")
    return out


def _touched(g, R, shapes, active=None):
    """(unique feature cells some nonzero-weight sample corner of the
    ``active`` rois touches, number of nonzero-weight (sample, corner)
    pairs) for the geometry table ``g`` on levels ``shapes``."""
    N = g.level.shape[0]
    device = g.level.device
    lvl = g.level.long()
    sizes = torch.tensor([list(hw) for hw in shapes], device=device)
    cells = sizes[:, 0] * sizes[:, 1]
    base = torch.cumsum((N // R) * cells, 0) - (N // R) * cells
    img = torch.arange(N, device=device) // R
    row0 = base[lvl] + img * cells[lvl]
    W = sizes[lvl, 1]
    idx = (row0[:, None, None, None, None]
           + g.y_idx.long()[:, :, None, :, None] * W[:, None, None, None, None]
           + g.x_idx.long()[:, None, :, None, :])
    need = (g.y_w[:, :, None, :, None] * g.x_w[:, None, :, None, :]) != 0
    if active is not None:
        need &= active[:, None, None, None, None]
    return torch.unique(idx[need]).numel(), int(need.sum())


def _axis_sizes(g):
    """Per roi, the unique rows and the unique columns that a sample
    corner reaches with a nonzero weight: the backward's |Ys| and |Xs|."""
    def unique(idx, w):
        v = torch.where(w != 0, idx, torch.full_like(idx, -1))
        v = v.reshape(len(v), -1).sort(dim=1).values
        new = (v[:, 1:] != v[:, :-1]) & (v[:, 1:] >= 0)
        return new.sum(1) + (v[:, 0] >= 0)
    return unique(g.y_idx, g.y_w), unique(g.x_idx, g.x_w)


def separable_counts(g, active=None):
    """(rois, mean and max unique touched cells per roi, their sum, max
    |Ys| and |Xs|) over the ``active`` rois of geometry table ``g``."""
    ny, nx = _axis_sizes(g)
    cells = ny * nx
    if active is not None:
        cells, ny, nx = cells[active], ny[active], nx[active]
    n = len(cells)
    return (n, cells.float().mean().item() if n else 0.0,
            int(cells.max()) if n else 0, int(cells.sum()),
            int(ny.max()) if n else 0, int(nx.max()) if n else 0)


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def roi_align_bwd_bound(dout, g, R, shapes, out_dtype):
    """(bound ms, bound_by, bytes, ops, unique cells) of roi_align_bwd on
    these inputs: the zero-fill of the float32 level gradients, one read of
    the cotangent and of the geometry, a float32 read and write of every
    cell a nonzero-weight corner of a roi with a nonzero cotangent
    touches, and the cast pass to ``out_dtype`` where there is one; one
    multiply-add (2 operations) per channel of each such corner update."""
    N = dout.shape[0]
    active = dout.reshape(N, -1).ne(0).any(dim=1)
    cells, pairs = _touched(g, R, shapes, active)
    acc = (N // R) * sum(h * w for h, w in shapes) * C * 4
    nbytes = (acc + dout.numel() * dout.element_size()
              + sum(t.numel() * t.element_size() for t in g)
              + cells * C * 4 * 2)
    if out_dtype != torch.float32:
        nbytes += acc + acc // 4 * torch.empty(0, dtype=out_dtype).element_size()
    ops = pairs * C * 2
    return (*_bound(nbytes, ops), nbytes, ops, cells)


def _train_batch(gen):
    """bench_train.py's batch: B random 480x640 images, G random GT boxes
    each, camera-shake PSFs (expl 0.005, fraction 0.5), all blurred."""
    from detectinblur_tpu_torch.ops.psf import sample_psf
    from detectinblur_tpu_torch.train.engine import BlurBatch

    h, w = SRC_HW
    rng = np.random.default_rng(0)
    boxes = np.zeros((B, TRAIN_G, 4), np.float32)
    boxes[..., 0] = rng.uniform(0, w // 2, (B, TRAIN_G))
    boxes[..., 1] = rng.uniform(0, h // 2, (B, TRAIN_G))
    boxes[..., 2] = boxes[..., 0] + rng.uniform(8, w // 3, (B, TRAIN_G))
    boxes[..., 3] = boxes[..., 1] + rng.uniform(8, h // 3, (B, TRAIN_G))
    return BlurBatch(
        images=torch.from_numpy(rng.random((B, h, w, 3), np.float32)).cuda(),
        hw=torch.tensor([SRC_HW] * B),
        psfs=sample_psf(B, expl=0.005, fraction=0.5, generator=gen,
                        device="cuda"),
        blurring=torch.ones(B, dtype=torch.bool, device="cuda"),
        gt_boxes=torch.from_numpy(boxes).cuda(),
        gt_labels=torch.from_numpy(
            rng.integers(1, 91, (B, TRAIN_G))).cuda(),
        gt_valid=torch.ones(B, TRAIN_G, dtype=torch.bool, device="cuda"))


def run_train(gen):
    """The training step with bench_train.py's protocol. Returns (launches
    per kernel in the counted step, the levels the step's RoIAlign forward
    read, the step's RoIAlign backward inputs)."""
    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
    )
    from detectinblur_tpu_torch.ops import roi_align_cuda
    from detectinblur_tpu_torch.ops.roi_align import RoIGeometry
    from detectinblur_tpu_torch.train.engine import (
        apply_blur_and_expand,
        images01,
        make_train_step,
    )
    from detectinblur_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )

    bucket = model_bucket_for_batch([SRC_HW] * B)
    model = FasterRCNN(FasterRCNNConfig(precision="default"), device="cuda")
    opt, schedule = make_optimizer(model, base_lr=0.04, steps_per_epoch=1000)
    state = create_train_state(model, opt)
    step = make_train_step(model, schedule, bucket, blur_train=True,
                           expand_target_boxes=True)
    batch = _train_batch(gen)

    # Warm-up; the second step records what the RoIAlign Function hands
    # roi_align_fwd (the levels) and roi_align_bwd (its cotangent and the
    # geometry saved by the forward).
    state, _ = step(state, batch, generator=gen)
    fn = roi_align_cuda._MultiscaleRoIAlign
    forward, backward = fn.forward, fn.backward
    levels, captured = [], []

    def capture_fwd(ctx, boxes, *features):
        levels.append([f.detach() for f in features])
        return forward(ctx, boxes, *features)

    def capture(ctx, dout):
        Bn, R = dout.shape[:2]
        captured.append((dout.reshape(Bn * R, 7, 7, -1).contiguous(),
                         RoIGeometry(*ctx.saved_tensors), R,
                         ctx.level_shapes, ctx.feature_dtype))
        return backward(ctx, dout)

    fn.forward, fn.backward = staticmethod(capture_fwd), staticmethod(capture)
    try:
        state, _ = step(state, batch, generator=gen)
    finally:
        fn.forward, fn.backward = staticmethod(forward), staticmethod(backward)
    torch.cuda.synchronize()

    # The main path, counted.
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    roi_align_cuda.roi_align_fwd.launches = 0
    roi_align_cuda.roi_align_bwd.launches = 0
    state, metrics = step(state, batch, generator=gen)
    torch.cuda.synchronize()
    launches = {"roi_align_fwd": roi_align_cuda.roi_align_fwd.launches,
                "roi_align_bwd": roi_align_cuda.roi_align_bwd.launches}
    print(f"train step: launches {launches}, losses "
          + json.dumps({k: v.item() for k, v in metrics.items()}))
    if min(launches.values()) == 0:
        sys.exit("the train step did not launch every kernel")
    if not all(torch.isfinite(v) for v in metrics.values()):
        sys.exit("non-finite training loss")
    trainable = {n for g in opt.param_groups for p in g["params"]
                 for n, q in model.named_parameters() if q is p}
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    print(f"parameters moved: {len(moved)} of {len(trainable)} trainable, "
          f"{len(moved - trainable)} of {len(before) - len(trainable)} frozen")
    if moved != trainable:
        sys.exit(f"moved != trainable: {sorted(moved ^ trainable)[:5]}")
    del before

    # Throughput: windows of device time, lower median.
    torch.cuda.reset_peak_memory_stats()
    windows, iters = 5, 4
    rates = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            state, _ = step(state, batch, generator=gen)
        end.record()
        torch.cuda.synchronize()
        rates.append(B * iters / (start.elapsed_time(end) / 1e3))
    img_s = sorted(rates)[(windows - 1) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # Per stage: the step's own calls, CUDA events between them.
    names = ("blur_expand", "forward_losses", "backward", "optimizer")
    acc = dict.fromkeys(names, 0.0)
    n = 5
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        b = apply_blur_and_expand(images01(batch), True, precision="default")
        ev[1].record()
        losses = model.loss(b.images, b.hw, b.gt_boxes, b.gt_labels,
                            b.gt_valid, bucket, generator=gen)
        total = sum(losses.values())
        ev[2].record()
        opt.zero_grad(set_to_none=True)
        total.backward()
        ev[3].record()
        for group in opt.param_groups:
            group["lr"] = schedule(state.step)
        opt.step()
        ev[4].record()
        torch.cuda.synchronize()
        state = state._replace(step=state.step + 1)
        for i, name in enumerate(names):
            acc[name] += ev[i].elapsed_time(ev[i + 1]) / n
    summary = {"img_s": img_s, "window_img_s": rates, "stage_ms": acc,
               "peak_mem_gib": peak}
    print("train " + json.dumps(summary))
    return launches, levels[0], captured[0]


def time_bwd_kernel(captured, launches, errs):
    """roi_align_bwd alone on the train step's own cotangent and geometry
    (zero-fill, kernel and cast to the features' dtype, as the Function
    calls it) vs the plain backward plus the same cast."""
    from detectinblur_tpu_torch.ops.roi_align import (
        roi_align_backward_from_geometry,
    )
    from detectinblur_tpu_torch.ops.roi_align_cuda import roi_align_bwd

    dout, geom, R, shapes, out_dtype = captured

    def plain():
        return [g.to(out_dtype) for g in roi_align_backward_from_geometry(
            dout, geom, R, shapes)]

    ms = _cuda_ms(lambda: roi_align_bwd(dout, geom, R, shapes, out_dtype), 20)
    plain_ms = _cuda_ms(plain, 3)
    bound_ms, bound_by, nbytes, ops, cells = roi_align_bwd_bound(
        dout, geom, R, shapes, out_dtype)
    mask = dout.reshape(dout.shape[0], -1).ne(0).any(dim=1)
    active = int(mask.sum())
    n, mean, top, total, my, mx = separable_counts(geom, mask)
    C_ = dout.shape[-1]
    print(f"roi_align_bwd separable form on the train step's {n} active rois,"
          f" by the geometry: unique touched cells per roi mean {mean:.2f}, "
          f"max {top} (|Ys| <= {my}, |Xs| <= {mx}), {total} in all, so "
          f"{total * C_ // 2} float2 REDs at one per touched cell and pair of "
          f"channels, against {784 * C_ * n} scalar REDs at 784 per roi and "
          f"channel")
    print(f"roi_align_bwd on the train step's cotangent ({tuple(dout.shape)} "
          f"{str(dout.dtype).split('.')[-1]}, {active} rois with a nonzero "
          f"cotangent, grads in {str(out_dtype).split('.')[-1]}): {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} "
          f"bytes, {cells} unique feature cells, {ops} operations)")
    return {
        "name": "roi_align_bwd",
        "route": "cuda",
        "source": "detectinblur_tpu_torch/csrc/roi_align_bwd.cu",
        "replaces": "detectinblur_tpu/ops/roi_align_pallas.py:484",
        "launches": launches,
        "max_abs_err": errs[dout.dtype],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def run_slice(gen):
    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
    )
    from detectinblur_tpu_torch.ops.blur import batched_blur
    from detectinblur_tpu_torch.ops.psf import sample_psf
    from detectinblur_tpu_torch.ops.roi_align_cuda import roi_align_fwd

    hw = np.tile(np.asarray([SRC_HW]), (B, 1))
    bucket = model_bucket_for_batch(hw)
    model = FasterRCNN(FasterRCNNConfig(precision="default"), device="cuda")
    # bench.py:90-103: zero the RPN delta head so proposals sit at the
    # anchors, the proposal shapes of a trained model (random deltas on a
    # random backbone decode into slivers a trained RPN never emits).
    with torch.no_grad():
        model.rpn_head.bbox_pred.weight.zero_()
        model.rpn_head.bbox_pred.bias.zero_()
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((B, *SRC_HW, 3), np.float32)).cuda()
    t0 = time.perf_counter()
    psfs = sample_psf(B, expl=0.005, fraction=0.5, generator=gen,
                      device="cuda")
    torch.cuda.synchronize()
    print(f"psf sampling (outside timing): {time.perf_counter() - t0:.2f} s")
    blurring = torch.ones(B, dtype=torch.bool, device="cuda")

    def blur_detect():
        blurred = batched_blur(images.permute(0, 3, 1, 2), psfs, blurring)
        return model.predict(blurred.permute(0, 2, 3, 1), hw, bucket)

    for _ in range(2):
        blur_detect()
    torch.cuda.synchronize()

    # The main path, counted.
    roi_align_fwd.launches = 0
    det = blur_detect()
    torch.cuda.synchronize()
    launches = roi_align_fwd.launches
    print(f"main path: roi_align_fwd launches {launches}")
    if launches == 0:
        sys.exit("the main path never launched roi_align_fwd")
    if det.boxes.shape != (B, 100, 4) or det.scores.shape != (B, 100):
        sys.exit(f"unexpected output shapes {det.boxes.shape} {det.scores.shape}")
    if not (torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()):
        sys.exit("non-finite detections")
    n_valid = det.valid.sum(1).tolist()
    print(f"valid detections per image: {n_valid}")
    if min(n_valid) < 1:
        sys.exit("an image has no valid detection")

    # Throughput: windows of device time, lower median.
    torch.cuda.reset_peak_memory_stats()
    windows, iters = 5, 5
    rates = [B * iters / (_cuda_ms(blur_detect, iters) * iters / 1e3)
             for _ in range(windows)]
    img_s = sorted(rates)[(windows - 1) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # Per stage, device time between CUDA events.
    names = ("blur", "preprocess", "backbone", "rpn", "roi_align",
             "head_postprocess")
    acc = dict.fromkeys(names, 0.0)
    n = 5
    with torch.inference_mode():
        for _ in range(n):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
            ev[0].record()
            blurred = batched_blur(images.permute(0, 3, 1, 2), psfs,
                                   blurring).permute(0, 2, 3, 1)
            ev[1].record()
            batched, new_hw = model.preprocess(blurred, hw, bucket)
            ev[2].record()
            feats = model.features(batched)
            ev[3].record()
            props, valid = model.propose(feats, new_hw)
            ev[4].record()
            pooled = model.pool(feats, props, valid)
            ev[5].record()
            model.detect(pooled, props, valid, new_hw, hw)
            ev[6].record()
            torch.cuda.synchronize()
            for i, name in enumerate(names):
                acc[name] += ev[i].elapsed_time(ev[i + 1]) / n
    rois = torch.where(valid[..., None], props, torch.zeros_like(props))
    summary = {"img_s": img_s, "window_img_s": rates,
               "stage_ms": acc, "peak_mem_gib": peak,
               "valid_proposals": valid.sum(1).tolist()}
    print("slice " + json.dumps(summary))
    return bucket, launches, [f for f in feats[:4]], rois


def time_fwd_kernel(feats, geom, R, where):
    """roi_align_fwd alone (from the geometry table ``geom``) vs the plain
    version from the same table, on levels ``feats`` in their dtype and in
    float32. Returns (ms, plain ms, bound ms, bound_by) in their dtype."""
    from detectinblur_tpu_torch.ops.roi_align import roi_align_from_geometry
    from detectinblur_tpu_torch.ops.roi_align_cuda import roi_align_fwd

    result = None
    for fs in (feats, [f.float() for f in feats]):
        with torch.inference_mode():
            ms = _cuda_ms(lambda: roi_align_fwd(fs, geom, R), 20)
            plain_ms = _cuda_ms(lambda: roi_align_from_geometry(fs, geom, R), 3)
        bound_ms, bound_by, nbytes, ops, cells = roi_align_bound(fs, geom, R)
        print(f"roi_align_fwd {str(fs[0].dtype).split('.')[-1]} on {where}: "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({nbytes} bytes, {cells} unique feature cells, {ops} "
              f"operations)")
        result = result or (ms, plain_ms, bound_ms, bound_by)
    n, mean, top, total, my, mx = separable_counts(geom)
    span = geom.y_idx[:, -1, 1] - geom.y_idx[:, 0, 0] + 1
    print(f"roi_align_fwd on {where}: unique touched cells per roi mean "
          f"{mean:.2f}, max {top} (|Ys| <= {my}, |Xs| <= {mx}), {total} in "
          f"all, against {784 * n} corner reads of the direct gather (784 "
          f"per roi); samples span at most 10 rows on "
          f"{int((span <= 10).sum())} of {n} rois")
    return result


def time_kernels(feats, rois, launches, errs):
    """The forward kernel on the main path's features and rois."""
    from detectinblur_tpu_torch.ops.roi_align import roi_geometry

    R = rois.shape[1]
    shapes = [f.shape[1:3] for f in feats]
    with torch.inference_mode():
        geom_ms = _cuda_ms(lambda: roi_geometry(rois.reshape(-1, 4), shapes), 20)
        geom = roi_geometry(rois.reshape(-1, 4), shapes)
    print(f"roi_align geometry (torch, shared by both versions): "
          f"{geom_ms:.4f} ms")
    ms, plain_ms, bound_ms, bound_by = time_fwd_kernel(
        feats, geom, R, "the main path's rois")
    return [{
        "name": "roi_align_fwd",
        "route": "cuda",
        "source": "detectinblur_tpu_torch/csrc/roi_align_fwd.cu",
        "replaces": "detectinblur_tpu/ops/roi_align_pallas.py:68",
        "launches": launches,
        "max_abs_err": errs[torch.bfloat16],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]


def check_against_cpu():
    """The card's predict (kernel, highest precision) vs the port's CPU
    predict (plain version) on two small images, same seed and weights:
    FPN levels within 2e-3 of each level's max magnitude, and 85% of the
    CPU's valid detections matched by label, IoU > 0.95 and score within
    2e-3 (the tolerances the CPU tests hold the port to against JAX)."""
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
    )
    from detectinblur_tpu_torch.models.roi_heads import BoxHeadConfig
    from detectinblur_tpu_torch.models.rpn import RPNConfig

    cfg = FasterRCNNConfig(min_size=128, max_size=160,
                           rpn=RPNConfig(pre_nms_top_n_test=400,
                                         post_nms_top_n_test=200),
                           box=BoxHeadConfig(nms_pool=2048),
                           precision="highest")
    hw = np.array([[110, 150], [128, 100]])
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.random((2, 128, 160, 3), np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        model = FasterRCNN(cfg, device=dev, seed=0)
        with torch.inference_mode():
            batched, _ = model.preprocess(imgs.to(dev), hw, (128, 160))
            feats = [f.float().cpu() for f in model.features(batched)]
            det = model.predict(imgs, hw, (128, 160))
        out[dev] = feats, [t.cpu() for t in det]
    worst = 0.0
    for fg, fc in zip(out["cuda"][0], out["cpu"][0]):
        worst = max(worst, ((fg - fc).abs().max() / fc.abs().max()).item())
    matched = []
    for b in range(2):
        gb, gs, gl, gv = (t[b] for t in out["cuda"][1])
        cb, cs, cl, cv = (t[b] for t in out["cpu"][1])
        gb, gs, gl = gb[gv], gs[gv], gl[gv]
        cb, cs, cl = cb[cv], cs[cv], cl[cv]
        lt = torch.maximum(cb[:, None, :2], gb[None, :, :2])
        rb = torch.minimum(cb[:, None, 2:], gb[None, :, 2:])
        inter = (rb - lt).clamp(min=0).prod(-1)
        area = lambda x: (x[:, 2:] - x[:, :2]).clamp(min=0).prod(-1)
        iou = inter / (area(cb)[:, None] + area(gb)[None] - inter).clamp(min=1e-9)
        iou = iou * (cl[:, None] == gl[None, :])
        best = iou.argmax(1)
        ok = ((iou[torch.arange(len(cb)), best] > 0.95)
              & ((cs - gs[best]).abs() < 2e-3))
        matched.append(ok.float().mean().item() if len(cb) else 0.0)
    print(f"card vs CPU on 2 small images: FPN max err / level max "
          f"{worst:.3g}, detections matched {matched}")
    if worst > 2e-3 or min(matched) <= 0.85:
        sys.exit("the card's predict disagrees with the CPU's")


def check_train_against_cpu():
    """The card's loss and gradients (kernels, highest precision) vs the
    port's CPU (plain versions) on two small images, same weights, same
    sampler draws. The RPN's cls_logits and bbox_pred weights are zeroed,
    as the CPU test against JAX does, so objectness and proposals are
    identical bit for bit on both devices and the samplers pick the same
    anchors and rois. Tolerances of that test: losses within 1e-4
    relative; each gradient within 1e-2 of its max, their median within
    5e-4, and exactly zero where the CPU's is."""
    from detectinblur_tpu_torch.models.anchors import grid_anchors
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
        LossDraws,
    )
    from detectinblur_tpu_torch.ops import roi_align_cuda

    bucket, G = (128, 160), 5
    cfg = FasterRCNNConfig(min_size=128, max_size=160, precision="highest")
    hw = np.array([[110, 150], [128, 100]])
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(rng.random((2, 128, 160, 3), np.float32))
    gt = np.zeros((2, G, 4), np.float32)
    gt[..., :2] = rng.uniform(0, 60, (2, G, 2))
    gt[..., 2:] = gt[..., :2] + rng.uniform(10, 50, (2, G, 2))
    labels = torch.from_numpy(rng.integers(1, 91, (2, G)))
    valid = torch.ones(2, G, dtype=torch.bool)
    shapes = [(bucket[0] // s, bucket[1] // s) for s in (4, 8, 16, 32)]
    shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
    A = sum(a.shape[0] for a in grid_anchors(tuple(shapes), bucket))
    PG = cfg.rpn.post_nms_top_n_train + G
    gen = torch.Generator().manual_seed(5)
    draws = LossDraws(rpn=(torch.rand(2, A, generator=gen),
                           torch.rand(2, A, generator=gen)),
                      roi=(torch.rand(2, PG, generator=gen),
                           torch.rand(2, PG, generator=gen)))
    out = {}
    for dev in ("cuda", "cpu"):
        model = FasterRCNN(cfg, device=dev, seed=0)
        with torch.no_grad():
            model.rpn_head.cls_logits.weight.zero_()
            model.rpn_head.cls_logits.bias.copy_(torch.tensor([0.3, -0.2, 0.1]))
            model.rpn_head.bbox_pred.weight.zero_()
            model.rpn_head.bbox_pred.bias.zero_()
        before = (roi_align_cuda.roi_align_fwd.launches,
                  roi_align_cuda.roi_align_bwd.launches)
        losses = model.loss(imgs, hw, torch.from_numpy(gt), labels, valid,
                            bucket, draws=LossDraws(
                                *(tuple(t.to(dev) for t in d) for d in draws)))
        sum(losses.values()).backward()
        if dev == "cuda" and (roi_align_cuda.roi_align_fwd.launches == before[0]
                              or roi_align_cuda.roi_align_bwd.launches
                              == before[1]):
            sys.exit("the card's loss did not launch both kernels")
        out[dev] = ({k: v.item() for k, v in losses.items()},
                    {n: p.grad.cpu() for n, p in model.named_parameters()})
    loss_err = max(abs(out["cuda"][0][k] - v) / abs(v)
                   for k, v in out["cpu"][0].items())
    errs = []
    for name, ref in out["cpu"][1].items():
        diff = (out["cuda"][1][name] - ref).abs().max().item()
        scale = ref.abs().max().item()
        errs.append(diff / scale if scale else (np.inf if diff else 0.0))
    print(f"card vs CPU train loss on 2 small images: losses {out['cpu'][0]}, "
          f"max relative loss error {loss_err:.3g}; gradient error / max "
          f"|grad|: max {max(errs):.3g}, median {np.median(errs):.3g}")
    if not (loss_err <= 1e-4 and max(errs) <= 1e-2
            and np.median(errs) <= 5e-4):
        sys.exit("the card's loss or gradients disagree with the CPU's")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    # The port and its kernel sources must come from this checkout.
    here = Path(__file__).resolve().parent
    if not (here / "detectinblur_tpu_torch" / "csrc").is_dir():
        sys.exit(f"chip_smoke: no detectinblur_tpu_torch/ beside {here}; "
                 "run it from a checkout of the repo")
    sys.path.insert(0, str(here))
    from detectinblur_tpu_torch.utils import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = cuda_build.build(["roi_align_fwd", "roi_align_bwd"])
    print(f"kernel build (in parallel): {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch

    bucket = model_bucket_for_batch([SRC_HW] * B)
    errs = check_kernels(bucket, gen)
    bwd_errs = check_bwd_kernel(bucket, gen)
    cuda_gen = torch.Generator(device="cuda").manual_seed(1)
    _, launches, feats, rois = run_slice(cuda_gen)
    kernels = time_kernels(feats, rois, launches, errs)
    del feats, rois
    train_launches, levels, captured = run_train(cuda_gen)
    time_fwd_kernel(levels, captured[1], captured[2], "the train step's rois")
    kernels.append(time_bwd_kernel(captured,
                                   train_launches["roi_align_bwd"], bwd_errs))
    del levels, captured
    check_against_cpu()
    check_train_against_cpu()

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
