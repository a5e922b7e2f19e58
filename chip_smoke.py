"""Drive the PyTorch port's serving, training, entry-point, remedy,
deblur-first, blur-estimator, ensemble, single-map detector,
natural-blur, person-keypoint, PSF-bank, data-parallel and benchmark
paths on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. Require CUDA; print the card's name and power limit.
  2. Build every kernel of the paths from the sources in the checkout (one
     nvcc per source, in parallel: both RoIAlign kernels, the greedy NMS
     pass and the conv epilogue); print ptxas's registers and spills.
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
     outputs, prove the path launched the forward kernel and the NMS
     kernel and made one conv-epilogue pass for each of its 49 folded
     norm groups, exit if anything in blur + predict synchronizes with the
     host (sync debug mode "warn"), time it (img/s and ms per stage with
     CUDA events; img/s with NMS through the kernel and the plain version
     in turns, predict eager on both sides). Its counted call and timed
     windows must replay predict's CUDA graphs, and one replayed call runs
     under the profiler: each hand kernel must run, counted by name, as
     often as the replay's count of it.
  5. Training, with bench_train.py's protocol: the same batch shape with
     16 random GT boxes per image, blur and PSF-driven GT expansion, then
     the loss, backward and SGD (lr 0.04, 1000 steps per epoch, warmup) of
     a model trained from scratch, ``default`` precision. Prove the step
     launched its three kernels and made the forward's 49 conv-epilogue
     passes, check the losses and which parameters
     moved, list what in the step still synchronizes with the host (not a
     gate), time it (img/s, ms per stage, peak memory; img/s with NMS
     through the kernel and the plain version in turns).
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
  8. The entry points, as a user runs them, at full width (ResNet50-FPN,
     91 classes, 800/1333, per-batch model buckets, the default
     ``highest`` precision) on a synthetic COCO directory made from seed 0
     (COCO's image sizes, 8 train and 16 val images, 2-6 boxes each over
     90 categories) and ``tests/torch_reference``'s He-scaled random
     weights in torchvision's layout (a ``.pth``, so that the eval has
     detections to score). ``cli.train.main`` (from that ``.pth``,
     blurred, expanded GT, batch 2, 3 steps, eval before and after) must
     launch both kernels, keep its losses finite and write ``model_0.pt``,
     whose ``restore_checkpoint`` gives back weights, momentum buffers and
     step bit for bit. ``cli.evaluate.main``, clean with that checkpoint
     and as a one-param blur sweep from the ``.pth``, must launch
     ``roi_align_fwd`` once per image (5 cells for the sweep). Every eval
     must give 19 finite stats with detections scored (AR100 >= 0) and
     launch ``nms_alive`` twice an image (the RPN's, the postprocess's);
     the eval step of the clean eval and the sweep runs under sync debug
     mode "warn" and must not synchronize with the host (the loop's
     readback of the detections lies outside the step).
     Each kernel is held against its plain version on the inputs each CLI
     handed it (one per model bucket and batch shape). The clean eval runs
     again under torch.profiler, for the device's busy share and each
     stage of the CLI's own step, four times with NMS through the kernel
     and the plain version in turns (the same stats; img/s and step ms,
     predict eager on both sides),
     and on the CPU, whose 19 stats must match the card's. Prints each eval loop's wall-clock img/s (a smoke
     reading: each bucket's first step is cold), the wall ms of its steps
     (CUDA events around each step) and the share outside them, the model
     buckets, the PSF banks' generation time and the peak memory.

  9. The paper's in-detector remedies at full width, ``default``
     precision, B=8 on 832x1088: a train step with every train-time
     remedy (blur, noise, block, JPEG, GT expansion, the Squint warp, the
     blur-conditional norms, BatchNorm in train mode), then an eval step
     with every eval-time one (PSF dilation, the corruptions, the warp,
     the norms, mode_one BatchNorm). Each must launch its kernels and no
     conv-epilogue pass (its BatchNorms do not fold), and the train step
     move every trainable parameter and every BatchNorm
     buffer; each kernel is held against its plain version on the
     step's own warped levels and cotangent and timed there; both steps
     are timed as phases 4 and 5 time theirs. Then the card against the
     CPU on a small input (a remedy train step's losses, gradients and
     BatchNorm statistics; a remedy eval step's detections; the JPEG),
     and the CLIs with the remedy flags: ``cli.train`` (3 steps, batch 2,
     from the random .pth, --unfrozen_batch_norm --warp_in_model
     --use_custom_image_norm, the three corruptions and AugMix), whose
     checkpoint must give back its BatchNorm buffers bit for bit, then
     ``cli.evaluate`` on it as a 5-cell sweep with --mode_one_norm,
     --dilate_psf, the warp, the norms and the corruptions.
 10. Deblur-first, the blur estimator and the LEHE ensemble: DeepDeblur's
     MSResNet at its published size (3 scales, 64 features, 19 blocks,
     synthetic weights) in float32 without TF32 on phase 4's batch and on
     one 832x1088 image, ms per image beside its FLOP bound, the card
     against the CPU on a small image; the resnet18 estimator's train step
     (16 classes, then 4) at B=8 on 832x1088 with every corruption, the
     min-side-800 blur and the crop, which must move every parameter and
     statistic, img/s and peak memory, the card against the CPU on a small
     input; then ``cli.train_blur_estimator --LEHE_blur_seg`` (3 steps, a
     checkpoint back bit for bit, then ``--test_only``) and
     ``cli.evaluate --use_ensemble --LEHE`` on four specialists (phase 8's
     checkpoint and three random ones) gated by that estimator after
     ``--deblur_first``, clean and as a sweep, and an oracle sweep: one
     forward launch per image, 19 finite stats, the kernel held on each
     eval's inputs, the chosen specialists printed, and the clean ensemble
     eval again on the CPU with the card's stats. Cut to 4 clean and 8
     sweep images an eval.
 11. The single-map detectors (``--model mobile_net|resnet_50``, full
     width: MobileNetV2's 1280 channels, the ResNet-50 C5's 2048) and the
     natural-blur data. (a) For each: blur + predict of phase 4's batch in
     the CLIs' bucket (832x1088, the model resizing to 300x400 inside it),
     ``default`` precision, random weights from seed 0: the forward kernel
     must launch, and is held against its plain version on the run's own
     rois and map (bfloat16 and float32) and timed against its bytes
     bound; img/s. (b) Phase 5's train step: both kernels launched, every
     parameter and (MobileNetV2) every running statistic moved, the
     backward held on the step's cotangent and timed against its bound;
     img/s and peak memory. (c) ``highest``, the card against the CPU:
     mobile_net's loss and gradients (within 3x the card's own spread
     under a 1e-6 nudge), resnet_50's predict. (d) ``cli.train --model
     mobile_net`` (3 steps; its checkpoint back bit for bit, running
     statistics included), ``cli.evaluate --model mobile_net`` on it
     (the CPU's 19 stats), ``--model resnet_50`` from a torso ``.pth``,
     then on a synthetic GOPRO sequence at 720x1280: ``dataset_tools
     render-gopro-synth`` and ``segment-gopro``, ``cli.evaluate
     --blurred_dataset GOPROSynth --expand_synth_boxes`` and
     ``GOPROSynthLoad``, and ``cli.train_blur_estimator --dataset
     GOPROBlurEst --LEHE_blur_seg`` (3 steps); each eval one forward
     launch per image, each kernel held on its inputs.

 12. Person keypoints, the bank writer and the profiling utilities: (a)
     ``cli.generate_psfs`` on the card at the published canvas 256,
     max_len 96, crop 128 and batch 128, cut to 128 PSFs in each of the
     15 folders (PSFs/s); every file fp16 128x128 with its support in the
     central window and its mass its exposure fraction, read back by
     ``load_psf_bank``. (b) ``cli.train --dataset coco_kp --blur_train
     --use_stored_psfs`` from that bank, on a synthetic person-keypoint
     COCO (phase 8's image sizes, 8 train and 6 val images, 2-6 people
     each with 17 keypoints, some unlabelled) at full width with 2
     classes, from a He-scaled 2-class ``.pth`` with heads made to score
     (batch 2, 3 steps, lr 1e-5): both kernels launched and held on their
     inputs, the checkpoint back bit for bit, the steps' img/s. (c)
     ``cli.evaluate --dataset coco_kp`` on it, clean and with
     ``--image_output_dir``: one forward launch per image held on its
     inputs, 19 finite stats with AP > 0 equal to the CPU's, one PNG per
     image, none binarized. (d) One eval step timed with
     ``utils/profiling.step_timer``, its ``device_memory_stats``, and the
     step under ``trace``, whose file must name the RoIAlign forward
     kernel.

 13. Data parallel (the port's DDP), on the one card. (a) Phase 8's
     ``cli.train`` in the launcher's environment at world size 1: an NCCL
     group, three steps through DDP, both kernels launched and held on
     their inputs, phase 8's first losses within 1e-4 relative, the group
     destroyed and a checkpoint that restores without one; then phase
     5's train step (B=8, ``default``) in DDP beside the plain step, in
     turns (img/s). (b) Two spawned ranks on ``cuda:0`` over gloo: the
     full-width step in ``highest`` (RPN prediction layers zeroed, so
     that both runs sample the same rois) on 4 + 4 images with per-image
     draws made here, against this process's step on all 8: losses
     within 1e-4, each update within 2e-3 of its tensor's largest, the
     ranks bit-identical; again with train-mode BatchNorm and the warp and
     norms, its running statistics within 1e-4 and its updates within 3x
     the one-process step's own spread under a 1e-6 nudge of the images;
     each kernel held on each rank's inputs; the rank's step ms and one
     all-reduce of the gradients' size (two ranks share one card: not a
     scaling number); then ``cli.evaluate --device cuda:0`` at W=2 on
     phase 8's COCO and checkpoint: phase 8's 19 stats exactly, 16
     forward launches over both ranks. (c) ``python -m
     torch.distributed.run --standalone --nproc_per_node 1 -m
     detectinblur_tpu_torch.cli.train ... --early_stop 1``: exit 0, an
     NCCL group, ``model_0.pt``.

 14. The greedy-NMS kernel (``csrc/nms.cu``, ``ops/nms.py::nms_alive``)
     held bit for bit against its plain version on the card: equal alive
     masks and equal (idxs, valid) from ``nms`` and ``batched_nms`` on
     each hard case of ``tests/nms_cases.py`` (float32 IoUs one ulp below,
     at and above the threshold, identical boxes with equal scores,
     zero-area boxes, every entry dead, N = 1 to 4097, 1% and 10% alive
     as a prefix and scattered, dead words between alive ones, one alive
     box in the last ragged word, NaN coordinates in a dead and an alive
     box, suppression chains across the 64- and 128-box boundaries, 90
     categories on a 1333 canvas, every box kept at 4096, one box that
     suppresses the rest, an odd word count) and on a card-only case of
     16385 boxes (the scan streams its row blocks in column tiles), from
     ``grouped_nms_presorted`` on the small ones as groups, and on what
     the RPN and the postprocess handed the NMS functions in phases 4, 5,
     8 and 11; each kernel call under
     ``torch.cuda.set_sync_debug_mode("error")``. On each greedy pass the
     mask kernel alone (``nms_mask``) is held word for word against
     ``_suppression_mask_plain`` on the words it must write (alive rows,
     from each row's own word on). Then the kernel timed on each of those
     inputs, whole and its mask and scan kernels apart (the scan's cost a
     64-box step), beside the plain version, its bound, and the mask
     kernel's own bound (alive pairs) and share; every path that runs NMS
     must have launched it.

 15. The benchmark entry points, as a user runs them: ``python -m
     detectinblur_tpu_torch.bench.{serve,train,pipeline}``, each a
     subprocess with the checkout on ``PYTHONPATH`` and its JAX twin's
     full protocol (``bench.py``, ``bench_train.py``,
     ``bench_pipeline.py``: 12 windows of 10 serving calls, the best of 3
     repeats of 50 train steps, 256 JPEGs through the loader over 8
     threads); each must exit 0 and end its stdout in one JSON line with
     its twin's keys and finite positive numbers, printed here. Then
     ``bench.pipeline``'s epoch in turns with its loader live and with
     the epoch's batches taken first (ms a step on the wall, in the
     step's calls and waiting on the loader). Then
     ``serve.run`` and ``train.run`` in this process at one window of 2
     calls under the launch counters (paths ``bench_serve``,
     ``bench_train``): each must launch its kernels, the conv epilogue 49
     times in each of its forwards (serving's 2 warm-up calls, the second
     capturing predict's CUDA graphs, and 2 timed calls, which must
     replay them; the train step's warm-up and 2 steps), each held against
     its plain version on the inputs they handed it.

 16. The conv-epilogue kernel (``csrc/conv_epilogue.cu``, the pass after
     each convolution whose FrozenBatchNorm folded into it): the shapes of
     the 49 passes of one ResNet50-FPN backbone forward at phase 4's
     shapes recorded (e.g. 8x64x416x544 without a residual, 8x256x208x272
     with one), then on
     each distinct shape, bfloat16 and float32, the kernel held bit for
     bit against its plain version and timed (replayed from a CUDA graph,
     and through its wrapper from Python) beside its bytes bound, the
     plain version and the unfolded ops it replaced (mul, add, residual
     add, ReLU); the totals of a forward's passes.

The last two lines are a JSON object describing each kernel (its
``launches`` summed over the counted runs of every path, one count per
path in ``launches_by_path``, its phase 11 readings per single-map
detector in ``single_map``, and the NMS kernel's readings on each path's
inputs in ``paths``) and ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

B, SRC_HW, C = 8, (480, 640), 256
TRAIN_R, TRAIN_G = 512, 16     # rois sampled and GT boxes per train image
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
EPILOGUE = "conv_epilogue"     # the conv epilogue's entry in the kernels line
PASSES = 49     # its passes in a ResNet-50 forward: the stem's, 3 a block
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
        out[dt] = _hold(f"roi_align_fwd {_name(dt)} at {tuple(rois.shape)} "
                        "rois", multiscale_roi_align_cuda(feats, rois),
                        multiscale_roi_align(feats, rois),
                        bf16_rounded=dt == torch.bfloat16)
    return out


def _name(dtype):
    return str(dtype).split(".")[-1]


def _hold(what, got, ref, bf16_rounded=False):
    """Print and return the max abs error of a kernel's output ``got``
    against its plain version's ``ref`` (a tensor or a list of them);
    exit unless they agree. The same samples and weights, float32 sums
    reassociated: within 1e-5 * max|plain|. With ``bf16_rounded`` both
    round one float32 sum to bf16, and reassociation can flip that
    rounding by one bf16 ulp (<= 2^-7 relative)."""
    torch.cuda.synchronize()
    pairs = [(g.float(), r.float()) for g, r in zip(
        *(x if isinstance(x, (list, tuple)) else [x] for x in (got, ref)))]
    err = max((g - r).abs().max().item() for g, r in pairs)
    scale = max(r.abs().max().item() for _, r in pairs)
    if bf16_rounded:
        ok = all(bool(((g - r).abs() <= 2 ** -7 * torch.maximum(g.abs(), r.abs())
                       + 1e-5 * scale).all()) for g, r in pairs)
        rule = "|k - p| <= 2^-7 max(|k|,|p|) + 1e-5 max|plain|"
    else:
        ok = err <= 1e-5 * scale
        rule = f"max_abs_err <= 1e-5 * max|plain| = {1e-5 * scale:.3g}"
    print(f"{what}: max_abs_err {err:.3g} (max|plain| {scale:.3g}), "
          f"tolerance {rule}: {'ok' if ok else 'FAILED'}")
    if not ok:
        sys.exit(f"{what}: the kernel disagrees with its plain version")
    return err


def roi_align_bound(feats, g, R):
    """(bound ms, bound_by, bytes, ops, unique cells) for the RoIAlign
    kernel on these inputs (geometry table ``g``, ``R`` rois per image):
    each output element written once, each feature cell that some sample's
    corner needs (nonzero weight) read once, the geometry table read once;
    16 multiply-adds per output element."""
    N, C = g.level.shape[0], feats[0].shape[-1]
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
        # Same products of the same (dtype-rounded) cotangent and weights;
        # only the order of the float32 sums differs (atomics).
        dout = dout32.to(dt).cuda()
        out[dt] = _hold(
            f"roi_align_bwd {_name(dt)} cotangent at {B} x {TRAIN_R} rois",
            roi_align_bwd(dout, geom, TRAIN_R, shapes),
            roi_align_backward_from_geometry(dout, geom, TRAIN_R, shapes))
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
    N, C = dout.shape[0], dout.shape[-1]
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


@contextlib.contextmanager
def _capture_roi_align(fwd, bwd):
    """While open, record what the RoIAlign Function hands its kernels,
    the first call of each shape and dtype: ``fwd`` gets (boxes, levels)
    keyed by (boxes' shape, level shapes, dtype, the one level's scale or
    None for P2..P5), ``bwd`` gets (cotangent,
    geometry saved by the forward, rois per image, level shapes, feature
    dtype) keyed by (cotangent's shape, level shapes, dtype). Nothing is
    launched for it, so the launch counts stay the path's own. A capture
    of predict's CUDA graphs records nothing (its tensors hold no values
    yet), and its replays run no Python: the first call of each of
    predict's keys runs eagerly, and ``_eager_predict`` makes others."""
    from detectinblur_tpu_torch.ops import roi_align_cuda
    from detectinblur_tpu_torch.ops.roi_align import RoIGeometry

    fn = roi_align_cuda._RoIAlign
    forward, backward = fn.forward, fn.backward

    def capture_fwd(ctx, boxes, spatial_scale, *features):
        key = (tuple(boxes.shape), tuple(tuple(f.shape[1:3]) for f in features),
               features[0].dtype, spatial_scale)
        if key not in fwd and not torch.cuda.is_current_stream_capturing():
            fwd[key] = (boxes.detach().clone(), [f.detach() for f in features])
        return forward(ctx, boxes, spatial_scale, *features)

    def capture_bwd(ctx, dout):
        Bn, R = dout.shape[:2]
        key = (tuple(dout.shape), tuple(ctx.level_shapes), dout.dtype)
        if key not in bwd:
            bwd[key] = (dout.reshape(Bn * R, 7, 7, -1).contiguous(),
                        RoIGeometry(*ctx.saved_tensors), R, ctx.level_shapes,
                        ctx.feature_dtype)
        return backward(ctx, dout)

    fn.forward, fn.backward = staticmethod(capture_fwd), staticmethod(capture_bwd)
    try:
        yield
    finally:
        fn.forward, fn.backward = staticmethod(forward), staticmethod(backward)


# What the RPN and the postprocess handed the NMS functions, per path:
# (path, function, input shapes) -> (function name, arguments), the first
# call of each shape (``_capture_nms``); phase 14 holds and times the
# kernel on them.
NMS_CAPTURED = {}


@contextlib.contextmanager
def _capture_nms(path):
    """While open, record in ``NMS_CAPTURED`` what ``models/rpn.py`` hands
    ``grouped_nms_presorted`` and ``models/roi_heads.py`` hands
    ``batched_nms`` under ``path``, the first call of each shape (clones:
    no kernel is launched for it) outside a capture of CUDA graphs, as
    ``_capture_roi_align``."""
    from detectinblur_tpu_torch.models import roi_heads, rpn

    sites = ((rpn, "grouped_nms_presorted"), (roi_heads, "batched_nms"))
    saved = [getattr(mod, name) for mod, name in sites]

    def recording(name, fn):
        def call(*args):
            key = (path, name, tuple(tuple(a.shape) for a in args
                                     if isinstance(a, torch.Tensor)))
            if (key not in NMS_CAPTURED
                    and not torch.cuda.is_current_stream_capturing()):
                NMS_CAPTURED[key] = (name, [
                    a.detach().clone() if isinstance(a, torch.Tensor) else a
                    for a in args])
            return fn(*args)
        return call

    for (mod, name), fn in zip(sites, saved):
        setattr(mod, name, recording(name, fn))
    try:
        yield
    finally:
        for (mod, name), fn in zip(sites, saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def _nms_route(plain, record=None):
    """While open, the NMS functions' greedy pass (``ops/nms.py::
    _alive_sorted``) runs the plain version (``plain``) or the kernel, as
    the port routes it; ``record`` gets each call's (boxes, alive in,
    threshold, alive out). ``predict`` runs eagerly meanwhile
    (``_eager_predict``), so turns timed under it time eager predict, not
    its replayed graphs. A measurement of this script: the package has
    no such switch."""
    from detectinblur_tpu_torch.ops import nms

    routed = nms._alive_sorted

    def route(sboxes, salive, thr):
        if plain:
            alive = nms._alive_sorted_plain(sboxes.float().contiguous(),
                                            salive.contiguous(), thr)
        else:
            alive = routed(sboxes, salive, thr)
        if record is not None:
            record.append((sboxes, salive, thr, alive))
        return alive

    nms._alive_sorted = route
    try:
        with _eager_predict():
            yield
    finally:
        nms._alive_sorted = routed


@contextlib.contextmanager
def _eager_predict():
    """While open, ``predict`` runs eagerly: a replay of its CUDA graphs
    (``utils/graphs.py``) runs no Python, so no patch of this script
    would reach it. The package has no such switch."""
    from detectinblur_tpu_torch.utils import graphs

    graphed = graphs.CallGraphs.__call__

    def eager(self, device, module, fn, key, tensors, make_consts):
        return fn(*tensors, make_consts())

    graphs.CallGraphs.__call__ = eager
    try:
        yield
    finally:
        graphs.CallGraphs.__call__ = graphed


@contextlib.contextmanager
def _watch_syncs(sites):
    """While open, ``torch.cuda.set_sync_debug_mode("warn")``: each
    synchronizing CUDA operation adds one to ``sites`` under the port's
    innermost file:line (function) that called it."""
    import traceback
    import warnings

    def show(message, *args, **kwargs):
        if "synchronizing CUDA operation" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "detectinblur_tpu_torch" in f.filename]
        key = "outside the port"
        if frames:
            f = frames[-1]
            rel = f.filename[f.filename.rindex("detectinblur_tpu_torch"):]
            key = f"{rel}:{f.lineno} ({f.name})"
        sites[key] = sites.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)


def _sync_sites(fn):
    """Run ``fn`` under ``_watch_syncs``; return its {site: count}."""
    sites = {}
    with _watch_syncs(sites):
        fn()
    torch.cuda.synchronize()
    return sites


def _step_img_s(step, state, batch, gen, windows=5, iters=4):
    """A train step's throughput: windows of ``iters`` steps timed with
    CUDA events, the lower median of their img/s. Returns (img/s, each
    window's img/s, the state after)."""
    rates = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            state, _ = step(state, batch, generator=gen)
        end.record()
        torch.cuda.synchronize()
        rates.append(batch.images.shape[0] * iters
                     / (start.elapsed_time(end) / 1e3))
    return sorted(rates)[(windows - 1) // 2], rates, state


def run_train(gen):
    """The training step with bench_train.py's protocol. Returns (launches
    per kernel in the counted step, the levels the step's RoIAlign forward
    read, the step's RoIAlign backward inputs)."""
    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
    )
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
    fwd, bwd = {}, {}
    with _capture_roi_align(fwd, bwd), _capture_nms("train_step"):
        state, _ = step(state, batch, generator=gen)
    torch.cuda.synchronize()
    (_, levels), = fwd.values()
    captured, = bwd.values()

    # The main path, counted.
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    (state, metrics), launches = _counted(
        lambda: step(state, batch, generator=gen))
    print(f"train step: launches {launches}, losses "
          + json.dumps({k: v.item() for k, v in metrics.items()}))
    if _missed(launches):
        sys.exit("the train step did not launch every kernel")
    _check_passes("train step", launches, 1)
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
    # What in the train step still waits on the host (listed, not gated),
    # on a generator of its own so that ``gen``'s stream stays the later
    # phases'.
    sites = {}
    with _watch_syncs(sites):
        state, _ = step(state, batch, generator=torch.Generator(
            device="cuda").manual_seed(6))
    torch.cuda.synchronize()
    print("train step, synchronizing CUDA operations by the port's "
          "innermost frame: " + json.dumps(sites))

    torch.cuda.reset_peak_memory_stats()
    img_s, rates, state = _step_img_s(step, state, batch, gen)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # NMS through the kernel and through the plain version, in turns, on
    # a generator of their own: ``gen``'s stream stays what the later
    # phases' inputs were made from before these turns existed.
    turns = {"kernel": [], "plain": []}
    turn_gen = torch.Generator(device="cuda").manual_seed(5)
    for route in ("kernel", "plain", "plain", "kernel"):
        with _nms_route(route == "plain"):
            rate, _, state = _step_img_s(step, state, batch, turn_gen,
                                         windows=1)
        turns[route].append(rate)

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
    summary = {"img_s": img_s, "window_img_s": rates,
               "nms_turns_img_s": turns, "stage_ms": acc,
               "peak_mem_gib": peak}
    print("train " + json.dumps(summary))
    return launches, levels, captured, img_s


def time_bwd_kernel(captured, launches, errs, where="the train step's"):
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
    print(f"roi_align_bwd separable form on {where} {n} active rois,"
          f" by the geometry: unique touched cells per roi mean {mean:.2f}, "
          f"max {top} (|Ys| <= {my}, |Xs| <= {mx}), {total} in all, so "
          f"{total * C_ // 2} float2 REDs at one per touched cell and pair of "
          f"channels, against {784 * C_ * n} scalar REDs at 784 per roi and "
          f"channel")
    print(f"roi_align_bwd on {where} cotangent ({tuple(dout.shape)} "
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

    with _capture_nms("serving"):
        blur_detect()
    blur_detect()
    torch.cuda.synchronize()

    # The main path, counted: the third call replays predict's graphs.
    (det, counted), graphed = _graphed(lambda: _counted(blur_detect))
    launches, nms_launches = counted["roi_align_fwd"], counted["nms_alive"]
    print(f"main path: launches {counted}, predict graphs {graphed}")
    if launches == 0 or nms_launches == 0:
        sys.exit("the main path never launched roi_align_fwd or nms_alive")
    if graphed != {"replay": 1}:
        sys.exit(f"the main path's third call ran {graphed}, not a replay")
    _check_passes("serving", counted, 1)
    _check_replays("serving", blur_detect)
    # Nothing in blur + predict may wait on the host.
    sites = _sync_sites(blur_detect)
    print("serving predict, synchronizing CUDA operations by the port's "
          "innermost frame: " + json.dumps(sites))
    if sites:
        sys.exit("serving predict synchronized with the host")
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
    rates, graphed = _graphed(lambda: [
        B * iters / (_cuda_ms(blur_detect, iters) * iters / 1e3)
        for _ in range(windows)])
    print(f"serving windows: predict graphs {graphed}")
    if set(graphed) != {"replay"}:
        sys.exit(f"serving windows ran {graphed}, not replays alone")
    img_s = sorted(rates)[(windows - 1) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # NMS through the kernel and through the plain version, in turns,
    # predict eager on both sides (``_nms_route``): not the serving rate,
    # which replays predict's graphs.
    turns = {"kernel": [], "plain": []}
    for route in ("kernel", "plain", "plain", "kernel"):
        with _nms_route(route == "plain"):
            turns[route].append(B * iters / (_cuda_ms(blur_detect, iters)
                                             * iters / 1e3))
    print("eager-predict img/s (not the replayed serving rate), NMS kernel "
          "vs plain in turns " + json.dumps(turns))

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
               "nms_turns_img_s": turns, "stage_ms": acc, "peak_mem_gib": peak,
               "valid_proposals": valid.sum(1).tolist()}
    print("slice " + json.dumps(summary))
    return (counted[EPILOGUE], launches, nms_launches,
            [f for f in feats[:4]], rois, img_s)


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


def _write_coco(root, n_cats=90, box_frac=(0.05, 0.6)):
    """The synthetic COCO directory of phase 8 (``tests/synthetic_coco``);
    phase 11 asks for few categories and large boxes, which random heads
    score."""
    from synthetic_coco import COCO_SIZES, write_coco

    sizes = lambda n: [COCO_SIZES[i % len(COCO_SIZES)] for i in range(n)]
    return write_coco(root, {"train2017": sizes(8), "val2017": sizes(16)},
                      seed=0, n_cats=n_cats, boxes=(2, 6), box_frac=box_frac)


def _kernels():
    """Each hand kernel's launch-counting wrapper, by the name of its
    entry in the ``kernels`` line."""
    from detectinblur_tpu_torch.ops import conv_epilogue, nms, roi_align_cuda

    return {"roi_align_fwd": roi_align_cuda.roi_align_fwd,
            "roi_align_bwd": roi_align_cuda.roi_align_bwd,
            "nms_alive": nms.nms_alive,
            EPILOGUE: conv_epilogue.conv_epilogue_kernel}


def _counted(fn):
    """(fn's result, launches of each kernel during fn) with the counts
    set to 0 just before and read just after: those its Python wrapper
    made, and those replays of predict's CUDA graphs made, which run no
    wrapper and count what their captures launched (``replayed``,
    ``utils/graphs.py``; printed apart, and held against the kernels a
    profiler sees by name on the serving path, ``_check_replays``)."""
    kernels = _kernels()
    for k in kernels.values():
        k.launches = k.replayed = 0
    out = fn()
    torch.cuda.synchronize()
    replayed = {name: k.replayed for name, k in kernels.items()
                if k.replayed}
    if replayed:
        print(f"  of which replayed graphs (their captures' counts): "
              f"{replayed}")
    return out, {name: k.launches + k.replayed
                 for name, k in kernels.items()}


# Each hand kernel's launch counter -> its device kernel's name (the scan
# kernel is the one every ``nms_alive`` call launches).
KERNEL_NAMES = {"roi_align_fwd": "roi_align_fwd_kernel",
                "roi_align_bwd": "roi_align_bwd_kernel",
                "nms_alive": "nms_scan_kernel",
                EPILOGUE: "conv_epilogue_kernel"}


def _check_replays(path, fn):
    """Run ``fn``, whose every predict must replay its CUDA graphs, under
    ``torch.profiler``, and exit unless each hand kernel ran on the card,
    counted by its name, as often as the replays said they launched it
    (the wrappers' ``replayed``), with no launch through a wrapper."""
    from torch.profiler import ProfilerActivity, profile

    kernels = _kernels()
    for k in kernels.values():
        k.launches = k.replayed = 0
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, graphed = _graphed(fn)
            torch.cuda.synchronize()
        trace = str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            ran = [e.get("name", "") for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    by_name = {name: sum(KERNEL_NAMES[name] in n for n in ran)
               for name in kernels}
    said = {name: k.replayed for name, k in kernels.items()}
    wrapped = {name: k.launches for name, k in kernels.items()}
    print(f"{path}: predict graphs {graphed}; the replays said they "
          f"launched {said}, the profiler saw by name {by_name}, the "
          f"wrappers launched {wrapped}")
    if set(graphed) != {"replay"} or any(wrapped.values()) or said != by_name:
        sys.exit(f"{path}: the replayed kernels differ from their count")


def _graphed(fn):
    """(fn's result, how ``utils/graphs.py`` ran predict during fn: the
    change of each nonzero count of ``graphs.counts``)."""
    from detectinblur_tpu_torch.utils import graphs

    before = dict(graphs.counts)
    out = fn()
    return out, {k: n - before[k] for k, n in graphs.counts.items()
                 if n != before[k]}


def _missed(launches):
    """Whether a RoIAlign or NMS kernel saw no launch in ``launches``
    (the conv epilogue runs only where FrozenBatchNorms fold, and
    ``_check_passes`` holds its count)."""
    return min(n for name, n in launches.items() if name != EPILOGUE) == 0


def _check_passes(path, launches, forwards):
    """Exit unless ``path`` launched the conv epilogue PASSES times for
    each of its ``forwards`` ResNet-50 forwards (0: none, the path does
    not fold)."""
    n = launches[EPILOGUE]
    print(f"{path}: {n} conv-epilogue passes for {forwards} ResNet-50 "
          f"forwards")
    if n != PASSES * forwards:
        sys.exit(f"{path}: {n} conv-epilogue passes, want {PASSES} for each "
                 f"of {forwards} ResNet-50 forwards")


def _check_stats(name, stats):
    """19 finite stats, with detections scored: AR100 is -1 only when no
    image of the eval has a detection."""
    stats = np.asarray(stats)
    print(f"{name}: 19 stats {np.round(stats, 4).tolist()}")
    if stats.shape != (19,) or not np.isfinite(stats).all():
        sys.exit(f"{name}: stats are not 19 finite numbers")
    if stats[8] < 0:
        sys.exit(f"{name}: no detection to score (AR100 {stats[8]})")


def check_captured(path, fwd, bwd):
    """Hold each kernel against its plain version on the inputs that
    ``path`` handed it (``_capture_roi_align``: the first call of each
    shape, so one per model bucket); returns the model buckets met."""
    from detectinblur_tpu_torch.ops.roi_align import (
        multiscale_roi_align,
        roi_align_backward_from_geometry,
    )
    from detectinblur_tpu_torch.ops.roi_align import roi_align_single_level
    from detectinblur_tpu_torch.ops.roi_align_cuda import (
        multiscale_roi_align_cuda,
        roi_align_bwd,
        roi_align_single_level_cuda,
    )

    def hw(shapes):
        stride = 4 if len(shapes) == 4 else 32
        return stride * shapes[0][0], stride * shapes[0][1]

    bucket = lambda shapes: "x".join(map(str, hw(shapes)))
    for (bshape, shapes, dt, scale), (boxes, feats) in fwd.items():
        if scale is None:
            got = lambda: multiscale_roi_align_cuda(feats, boxes)
            ref = lambda: multiscale_roi_align(feats, boxes)
        else:
            got = lambda: roi_align_single_level_cuda(feats[0], boxes, scale)
            ref = lambda: torch.stack([roi_align_single_level(
                feats[0][b], boxes[b], scale) for b in range(bshape[0])])
        with torch.no_grad():
            _hold(f"{path}: roi_align_fwd {_name(dt)} at B={bshape[0]} x "
                  f"{bshape[1]} rois on bucket {bucket(shapes)}"
                  + ("" if scale is None else " (one level)"), got(), ref(),
                  bf16_rounded=dt == torch.bfloat16)
    for (_, shapes, dt), (dout, geom, R, level_shapes, _) in bwd.items():
        _hold(f"{path}: roi_align_bwd {_name(dt)} cotangent at "
              f"{dout.shape[0] // R} x {R} rois on bucket {bucket(shapes)}",
              roi_align_bwd(dout, geom, R, level_shapes),
              roi_align_backward_from_geometry(dout, geom, R, level_shapes))
    return {hw(shapes) for _, shapes, _, _ in fwd}


STAGES = ("eval.to_device", "eval.blur_expand", "predict.preprocess",
          "predict.backbone", "predict.rpn", "predict.roi_align",
          "predict.head_postprocess")


def profile_eval(argv, loops):
    """``cli.evaluate.main(argv)`` under torch.profiler. Returns its stats
    and, per evaluated image: the device's busy time (kernel time) and its
    share of the eval loop's wall clock and of the steps' wall time; each
    profiler range of the step (``STAGES``) on the host's clock, the
    kernel time launched inside it, and its span on the device; and the
    kernels that take most of the device's time."""
    from torch.profiler import ProfilerActivity, profile

    import detectinblur_tpu_torch.cli.evaluate as cli_eval

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats = cli_eval.main(argv)
    loop = loops[-1]
    n = loop["images"]
    cuda = torch.autograd.DeviceType.CUDA
    avg = prof.key_averages()
    kernels = [e for e in avg if e.device_type == cuda and e.key not in STAGES
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n   # ms
    stages = {}
    for e in avg:
        if e.key in STAGES:
            s = stages.setdefault(e.key, {})
            if e.device_type == cuda:
                s["device_span_ms"] = e.device_time_total / 1e3 / n
            else:
                s["host_ms"] = e.cpu_time_total / 1e3 / n
                s["kernel_ms"] = e.device_time_total / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return stats, {
        "images": n, "wall_s": loop["wall_s"],
        "step_ms_per_image": loop["step_ms_per_image"],
        "device_busy_ms_per_image": busy or "not measured",
        "device_busy_share_of_loop": busy * n / (loop["wall_s"] * 1e3)
        if busy else "not measured",
        "device_busy_share_of_steps": busy / loop["step_ms_per_image"]
        if busy else "not measured",
        "stages_per_image": {k: stages[k] for k in STAGES if k in stages},
        "top_kernels_ms_per_image": [
            (e.key[:70], e.self_device_time_total / 1e3 / n, e.count / n)
            for e in top]}


def _phase8_files(tmp):
    """Phase 8's synthetic COCO and random torchvision-layout ``.pth`` in
    ``tmp``, made from their seeds (the same files on every call)."""
    from torch_reference import make_random_fasterrcnn_sd

    root = _write_coco(str(Path(tmp) / "coco"))
    pth = str(Path(tmp) / "random_torchvision.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                make_random_fasterrcnn_sd(np.random.default_rng(0)).items()},
               pth)
    return root, pth


def _phase8_train_argv(root, out, pth):
    """Phase 8's ``cli.train``: blurred, expanded GT, batch 2, 3 steps,
    eval before and after. lr 1e-5: after 3 steps the random model still
    scores boxes above the 0.05 threshold (at 2.5e-3 it scored none), so
    every eval has detections to score."""
    return ["--data-path", root, "--blur_train", "--expand_target_boxes",
            "-b", "2", "--epochs", "1", "--early_stop", "3",
            "--output_dir", out, "--eval_first", "--print-freq", "1",
            "--lr", "1e-5", "--start_from_weights", pth]


def run_entry_points(keep):
    """Phase 8: cli.train, then cli.evaluate clean and as a blur sweep, on
    a synthetic COCO, each kernel held against its plain version on the
    inputs each CLI handed it; then the clean eval again under the
    profiler and on the CPU. Copies cli.train's ``model_0.pt`` into
    ``keep`` (phase 10's first specialist, phase 13's checkpoint).
    Returns the launches of each kernel per CLI, and ``cli.train``'s first
    losses and the clean eval's stats (phase 13 holds its runs to them)."""
    import shutil

    import tempfile

    import detectinblur_tpu_torch.cli.evaluate as cli_eval
    import detectinblur_tpu_torch.cli.train as cli_train
    from detectinblur_tpu_torch.data import blur_sampling
    from detectinblur_tpu_torch.train import eval_loop

    banks, loops, path = [], [], ["cli.train"]

    def timed_bank(generator, **kw):
        t0 = time.perf_counter()
        bank = blur_sampling.generate_psf_bank(generator, **kw)
        torch.cuda.synchronize()
        banks.append({"shape": list(bank.shape), "iters": kw.get("iters", 2000),
                      "s": time.perf_counter() - t0})
        return bank

    step_syncs = {}

    def recorded_eval(eval_step, *args, **kwargs):
        def watched(*a, **k):
            # The step itself, under sync debug "warn": the loop's collect
            # (the detections' readback, as JAX's device_get) is outside.
            with _watch_syncs(step_syncs.setdefault(path[0], {})):
                return eval_step(*a, **k)

        watch = path[0] in ("cli.evaluate clean", "cli.evaluate sweep P1")
        stats, loop = eval_loop.evaluate_coco(
            watched if watch else eval_step, *args, **kwargs)
        loops.append(dict(path=path[0], **loop))
        return stats, loop

    cli_train.generate_psf_bank = cli_eval.generate_psf_bank = timed_bank
    cli_train.evaluate_coco = cli_eval.evaluate_coco = recorded_eval
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        root, pth = _phase8_files(tmp)
        out = str(Path(tmp) / "out")
        fwd, bwd = {}, {}
        t0 = time.perf_counter()
        with _capture_roi_align(fwd, bwd), _capture_nms("cli.train"):
            run, train_launches = _counted(lambda: cli_train.main(
                _phase8_train_argv(root, out, pth)))
        print(f"cli.train: {time.perf_counter() - t0:.2f} s, launches "
              f"{train_launches}, losses " + json.dumps(run.losses))
        if _missed(train_launches):
            sys.exit("cli.train did not launch every kernel")
        if len(run.losses) != 3 or not all(
                np.isfinite(v) for m in run.losses for v in m.values()):
            sys.exit("cli.train: missing or non-finite losses")
        for tag, stats in sorted(run.evals.items()):
            _check_stats(f"cli.train eval {tag}", stats)
        check_captured("cli.train", fwd, bwd)
        del fwd, bwd

        ckpt = Path(out) / "model_0.pt"
        if not _same_checkpoint(ckpt, run, cli_train.build_model(
                cli_train.train_parser().parse_args([]), "cuda")):
            sys.exit("restore_checkpoint did not give the state back bit for bit")
        shutil.copy(ckpt, keep / ckpt.name)
        first_losses = run.losses[0]
        del run

        eval_launches = dict.fromkeys(_kernels(), 0)
        buckets = set()
        clean = ["--data-path", root, "--resume", str(ckpt), "--vanilla_eval"]
        sweep = ["--data-path", root, "--start_from_weights", pth,
                 "--blur_eval", "--param_index", "1"]
        for name, argv, cells in (("clean", clean, 1), ("sweep P1", sweep, 5)):
            path[0] = f"cli.evaluate {name}"
            fwd = {}
            t0 = time.perf_counter()
            with _capture_roi_align(fwd, {}), _capture_nms(path[0]):
                (got, launches), graphed = _graphed(
                    lambda: _counted(lambda: cli_eval.main(argv)))
            print(f"{path[0]}: {time.perf_counter() - t0:.2f} s, launches "
                  f"{launches}, predict graphs {graphed}")
            results = {0: got} if cells == 1 else got
            if len(results) != cells:
                sys.exit(f"{path[0]}: {len(results)} cells, want {cells}")
            for cell, stats in sorted(results.items()):
                _check_stats(f"{path[0]} {cell}", stats)
            if (launches["roi_align_fwd"] != 16 * cells
                    or launches["nms_alive"] != 2 * 16 * cells):
                sys.exit(f"{path[0]}: launches {launches} for {16 * cells} "
                         f"images (one roi_align_fwd and two nms_alive, the "
                         f"RPN's and the postprocess's, an image)")
            for k, v in launches.items():
                eval_launches[k] += v
            buckets |= check_captured(path[0], fwd, {})
            del fwd
            if cells == 1:
                clean_stats = got
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print("eval step, synchronizing CUDA operations by the port's "
              "innermost frame: " + json.dumps(step_syncs))
        if any(step_syncs.values()):
            sys.exit("the eval step synchronized with the host")

        path[0] = "cli.evaluate clean, profiled"
        _, profiled = profile_eval(clean, loops)
        print("eval profile " + json.dumps(profiled))
        # The clean eval with NMS through the kernel and through the plain
        # version, in turns: img/s and the steps' ms an image.
        turns = {"kernel": [], "plain": []}
        for route in ("kernel", "plain", "plain", "kernel"):
            path[0] = f"cli.evaluate clean, NMS {route}"
            with _nms_route(route == "plain"):
                stats = cli_eval.main(clean)
            if not np.array_equal(stats, clean_stats):
                sys.exit(f"{path[0]}: stats differ from the clean eval's")
            turns[route].append({k: loops[-1][k] for k in (
                "img_s", "step_ms_per_image")})
        print("eval, NMS kernel vs plain in turns (stats equal) "
              + json.dumps(turns))
        # The card's clean eval against the CPU's (the plain versions), on
        # the same checkpoint and images: the CPU tests' tolerance against
        # JAX, 1e-3 absolute and 1e-3 of each stat; and the detections
        # above the score threshold within 2% in number (a float32 score
        # near the threshold or an NMS tie may fall either way).
        path[0] = "cli.evaluate clean, CPU"
        t0 = time.perf_counter()
        cpu_stats = cli_eval.main(clean + ["--device", "cpu"])
        err = np.abs(np.asarray(clean_stats) - cpu_stats)
        dets = [s["detections"] for s in loops
                if s["path"] in ("cli.evaluate clean", path[0])]
        ok = bool(((err <= 1e-3) & (err <= 1e-3 * np.abs(cpu_stats) + 1e-7))
                  .all()) and abs(dets[0] - dets[1]) <= 0.02 * dets[1]
        print(f"card vs CPU clean eval ({time.perf_counter() - t0:.2f} s on "
              f"the CPU): max |stat difference| {err.max():.3g}, tolerance "
              f"1e-3 and 1e-3 of each stat; detections {dets[0]} vs "
              f"{dets[1]}, tolerance 2%: {'ok' if ok else 'FAILED'}")
        if not ok:
            sys.exit("the card's eval disagrees with the CPU's")
    for s in loops:
        print("eval loop " + json.dumps(s))
    main_loops = [s for s in loops if s["path"] in ("cli.evaluate clean",
                                                    "cli.evaluate sweep P1")]
    n = sum(s["images"] for s in main_loops)
    wall = sum(s["wall_s"] for s in main_loops)
    step = sum(s["step_ms_per_image"] * s["images"] for s in main_loops)
    # A smoke reading: 16 images an eval, each bucket's first step cold.
    print("entry points " + json.dumps({
        "eval_img_s_smoke": n / wall, "eval_step_ms_per_image": step / n,
        "eval_share_outside_steps": 1 - step / 1e3 / wall, "eval_images": n,
        "eval_device_busy_ms_per_image": profiled["device_busy_ms_per_image"],
        "eval_device_busy_share_of_steps":
            profiled["device_busy_share_of_steps"],
        "eval_nms_turns": turns,
        "model_buckets": sorted(buckets), "psf_banks": banks,
        "peak_mem_gib": peak}))
    return ({"cli_train": train_launches, "cli_evaluate": eval_launches},
            {"first_losses": first_losses, "clean_stats": clean_stats})


# ----------------------------------------------------------- remedies
REMEDY_TRAIN = dict(blur_train=True, expand_target_boxes=True, use_warp=True,
                    use_custom_norm=True, add_noise=True, add_block=True,
                    add_jpeg=True)
REMEDY_EVAL = dict(blur_eval=True, expand_target_boxes=True, use_warp=True,
                   use_custom_norm=True, add_noise=True, add_block=True,
                   add_jpeg=True, dilate_psf=True)
BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


def _remedy_batch(gen):
    """The train batch with the (blur type, exposure) indices of its PSFs
    (expl 0.005 = BLUR_PARAMS[0], fraction 0.5 = BLUR_FRACTIONS[3]), which
    the blur-conditional norms read."""
    batch = _train_batch(gen)
    full = lambda v: torch.full((B,), v, dtype=torch.int32, device="cuda")
    return batch._replace(param_index=full(0), fraction_index=full(3))


def _bn_stats(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.rpartition(".")[2] in BN_STATS}


def run_remedy_train(gen):
    """Phase 9a: the train step with every train-time remedy (blur, noise,
    block, JPEG, GT expansion, the warp, the blur-conditional norms,
    BatchNorm in train mode) at full width, B=8 on 832x1088, ``default``
    precision. Proves the step launched both kernels and moved the
    BatchNorm statistics, holds the kernels against their plain versions
    on the step's own (warped) levels and cotangent, and times it as
    run_train times the plain step. Returns the launches and img/s."""
    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
    )
    from detectinblur_tpu_torch.ops.roi_align import roi_geometry
    from detectinblur_tpu_torch.train.engine import (
        remedy_kwargs,
        apply_blur_and_expand,
        derive_warp_params,
        images01,
        make_train_step,
    )
    from detectinblur_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )

    bucket = model_bucket_for_batch([SRC_HW] * B)
    model = FasterRCNN(FasterRCNNConfig(precision="default",
                                        warp_internally=True,
                                        bn_mode="train"), device="cuda")
    opt, schedule = make_optimizer(model, base_lr=0.04, steps_per_epoch=1000)
    state = create_train_state(model, opt)
    step = make_train_step(model, schedule, bucket, **REMEDY_TRAIN)
    batch = _remedy_batch(gen)

    state, _ = step(state, batch, generator=gen)
    fwd, bwd = {}, {}
    with _capture_roi_align(fwd, bwd):
        state, _ = step(state, batch, generator=gen)
    torch.cuda.synchronize()

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = _bn_stats(model)
    (state, metrics), launches = _counted(
        lambda: step(state, batch, generator=gen))
    print(f"remedy train step: launches {launches}, losses "
          + json.dumps({k: v.item() for k, v in metrics.items()}))
    if _missed(launches):
        sys.exit("the remedy train step did not launch every kernel")
    _check_passes("remedy train step", launches, 0)
    if not all(torch.isfinite(v) for v in metrics.values()):
        sys.exit("non-finite remedy training loss")
    trainable = {n for g in opt.param_groups for p in g["params"]
                 for n, q in model.named_parameters() if q is p}
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    stats1 = _bn_stats(model)
    stats_moved = sum(not torch.equal(stats0[k], stats1[k]) for k in stats0)
    counts = {v.item() - stats0[k].item() for k, v in stats1.items()
              if k.endswith("num_batches_tracked")}
    print(f"remedy train step: parameters moved {len(moved)} of "
          f"{len(trainable)} trainable; BatchNorm buffers moved "
          f"{stats_moved} of {len(stats0)}, counts advanced by {counts}")
    if moved != trainable or stats_moved != len(stats0) or counts != {1.0}:
        sys.exit("the remedy train step moved the wrong tensors")
    del before, stats0, stats1
    check_captured("remedy train step", fwd, bwd)
    (boxes, levels), = fwd.values()
    time_fwd_kernel(levels, roi_geometry(boxes.reshape(-1, 4), [
        f.shape[1:3] for f in levels]), boxes.shape[1],
        "the remedy train step's rois (warped levels)")
    captured, = bwd.values()
    time_bwd_kernel(captured, launches["roi_align_bwd"],
                    {captured[0].dtype: 0}, "the remedy train step's")
    del fwd, bwd, boxes, levels, captured

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

    names = ("blur_corrupt_expand", "warp_params_norms", "forward_losses",
             "backward", "optimizer")
    acc = dict.fromkeys(names, 0.0)
    n = 5
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        b = apply_blur_and_expand(images01(batch), True, precision="default",
                                  add_noise=True, add_block=True,
                                  add_jpeg=True, generator=gen)
        ev[1].record()
        b = derive_warp_params(b)
        kw = remedy_kwargs(b, True, True)
        ev[2].record()
        losses = model.loss(b.images, b.hw, b.gt_boxes, b.gt_labels,
                            b.gt_valid, bucket, generator=gen, **kw)
        total = sum(losses.values())
        ev[3].record()
        opt.zero_grad(set_to_none=True)
        total.backward()
        ev[4].record()
        for group in opt.param_groups:
            group["lr"] = schedule(state.step)
        opt.step()
        ev[5].record()
        torch.cuda.synchronize()
        state = state._replace(step=state.step + 1)
        for i, name in enumerate(names):
            acc[name] += ev[i].elapsed_time(ev[i + 1]) / n
    print("remedy train " + json.dumps({
        "img_s": img_s, "window_img_s": rates, "stage_ms": acc,
        "peak_mem_gib": peak}))
    return launches, img_s


def run_remedy_predict(gen):
    """Phase 9b: the eval step with every eval-time remedy (PSF dilation,
    blur, noise, block, JPEG, GT expansion, the warp, the norms, mode_one
    BatchNorm) at full width, B=8 on 832x1088, ``default`` precision, with
    ``tests/torch_reference``'s random torchvision weights taken as
    ``cli.evaluate --mode_one_norm`` takes a .pth (BatchNorm unfolded, a
    count of 16) and the RPN delta head zeroed as in serving. Proves it
    launched the forward kernel, checks its outputs, holds the kernel
    against its plain version on the warped levels, and times it.
    Returns (launches, img/s)."""
    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
    )
    from detectinblur_tpu_torch.ops.roi_align import roi_geometry
    from detectinblur_tpu_torch.train.engine import (
        remedy_kwargs,
        derive_warp_params,
        make_eval_step,
        prepare_eval_batch,
        to_device,
    )
    from detectinblur_tpu_torch.utils.convert import params_from_torchvision
    from torch_reference import make_random_fasterrcnn_sd

    bucket = model_bucket_for_batch([SRC_HW] * B)
    model = FasterRCNN(FasterRCNNConfig(precision="default",
                                        warp_internally=True,
                                        bn_mode="mode_one"), device="cuda")
    model.load_state_dict(params_from_torchvision(
        make_random_fasterrcnn_sd(np.random.default_rng(0)), frozen_bn=False,
        num_batches=16.0))
    with torch.no_grad():
        model.rpn_head.bbox_pred.weight.zero_()
        model.rpn_head.bbox_pred.bias.zero_()
    step = make_eval_step(model, bucket, **REMEDY_EVAL)
    batch = _remedy_batch(gen)
    run = lambda: step(model, batch, gen)
    for _ in range(2):
        run()
    fwd = {}
    with _capture_roi_align(fwd, {}), _eager_predict():
        run()
    (det, gt), launches = _counted(run)
    print(f"remedy predict: launches {launches}")
    if launches["roi_align_fwd"] == 0:
        sys.exit("the remedy predict never launched roi_align_fwd")
    _check_passes("remedy predict", launches, 0)
    if det.boxes.shape != (B, 100, 4) or not (
            torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()
            and torch.isfinite(gt).all()):
        sys.exit("the remedy predict gave wrong or non-finite outputs")
    print(f"remedy predict: valid detections per image "
          f"{det.valid.sum(1).tolist()}")
    check_captured("remedy predict", fwd, {})
    (boxes, levels), = fwd.values()
    time_fwd_kernel(levels, roi_geometry(boxes.reshape(-1, 4), [
        f.shape[1:3] for f in levels]), boxes.shape[1],
        "the remedy predict's rois (warped levels)")
    del fwd, boxes, levels
    torch.cuda.reset_peak_memory_stats()
    windows, iters = 5, 5
    rates = [B * iters / (_cuda_ms(run, iters) * iters / 1e3)
             for _ in range(windows)]
    img_s = sorted(rates)[(windows - 1) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # Per stage, the eval step's own calls, CUDA events between them.
    names = ("to_device_dilate_blur_corrupt_expand", "warp_params_norms",
             "preprocess", "backbone_and_warps", "rpn", "roi_align",
             "head_postprocess")
    acc = dict.fromkeys(names, 0.0)
    n = 5
    with torch.inference_mode():
        for _ in range(n):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
            ev[0].record()
            b = prepare_eval_batch(
                to_device(batch, "cuda"), gen, precision="default",
                **{k: v for k, v in REMEDY_EVAL.items()
                   if k not in ("use_warp", "use_custom_norm")})
            ev[1].record()
            b = derive_warp_params(b)
            kw = remedy_kwargs(b, True, True)
            ev[2].record()
            batched, new_hw = model.preprocess(b.images, b.hw, bucket,
                                               kw["means"], kw["stds"])
            ev[3].record()
            feats = model.features(batched, kw["thetas"], kw["lam1s"],
                                   kw["lam2s"])
            ev[4].record()
            props, valid = model.propose(feats, new_hw)
            ev[5].record()
            pooled = model.pool(feats, props, valid)
            ev[6].record()
            model.detect(pooled, props, valid, new_hw, b.hw)
            ev[7].record()
            torch.cuda.synchronize()
            for i, name in enumerate(names):
                acc[name] += ev[i].elapsed_time(ev[i + 1]) / n
    print("remedy predict " + json.dumps({
        "img_s": img_s, "window_img_s": rates, "stage_ms": acc,
        "peak_mem_gib": peak}))
    return launches, img_s


def _match_share(got, ref):
    """Per image, the share of ``ref``'s valid detections that ``got``
    matches by label, IoU > 0.95 and score within 2e-3."""
    shares = []
    for b in range(ref.boxes.shape[0]):
        gb, gs, gl = (t[b][got.valid[b]] for t in got[:3])
        cb, cs, cl = (t[b][ref.valid[b]] for t in ref[:3])
        lt = torch.maximum(cb[:, None, :2], gb[None, :, :2])
        rb = torch.minimum(cb[:, None, 2:], gb[None, :, 2:])
        inter = (rb - lt).clamp(min=0).prod(-1)
        area = lambda x: (x[:, 2:] - x[:, :2]).clamp(min=0).prod(-1)
        iou = inter / (area(cb)[:, None] + area(gb)[None] - inter).clamp(min=1e-9)
        iou = iou * (cl[:, None] == gl[None, :])
        if not len(cb) or not len(gb):
            shares.append(float(len(cb) == len(gb)))
            continue
        best = iou.argmax(1)
        ok = ((iou[torch.arange(len(cb)), best] > 0.95)
              & ((cs - gs[best]).abs() < 2e-3))
        shares.append(ok.float().mean().item())
    return shares


def _remedy_train_outputs(cfg, dev, batch, draws, cdraws, nudge=None):
    """One remedy train step (warp, norms, blur, noise, block, GT
    expansion) of a seed-0 model ``cfg`` on ``dev``, the RPN's prediction
    layers zeroed so every device samples the same anchors and rois ->
    (losses, gradients, BatchNorm statistics after the step) on the CPU.
    ``nudge`` is added to the images first."""
    from detectinblur_tpu_torch.models.faster_rcnn import FasterRCNN, LossDraws
    from detectinblur_tpu_torch.train.engine import make_train_step
    from detectinblur_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )

    model = FasterRCNN(cfg, device=dev, seed=0)
    with torch.no_grad():
        model.rpn_head.cls_logits.weight.zero_()
        model.rpn_head.cls_logits.bias.copy_(torch.tensor([0.3, -0.2, 0.1]))
        model.rpn_head.bbox_pred.weight.zero_()
        model.rpn_head.bbox_pred.bias.zero_()
    opt, schedule = make_optimizer(model, base_lr=0.02, steps_per_epoch=1)
    step = make_train_step(model, schedule, (128, 160),
                           **dict(REMEDY_TRAIN, add_jpeg=False))
    if nudge is not None:
        batch = batch._replace(images=batch.images + nudge)
    _, m = step(create_train_state(model, opt), batch, draws=LossDraws(
        *(tuple(t.to(dev) for t in d) for d in draws)),
        corruption_draws=cdraws)
    return ({k: v.item() for k, v in m.items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()
             if p.grad is not None},
            {k: v.cpu() for k, v in _bn_stats(model).items()})


def _train_errors(got, ref):
    """(max relative loss error, max and median over tensors of the
    gradient error / max |gradient|, max BatchNorm statistic error /
    max(1, its magnitude)) of ``got`` against ``ref``."""
    loss = max(abs(got[0][k] - v) / abs(v) for k, v in ref[0].items())
    errs = []
    for name, r in ref[1].items():
        diff = (got[1][name] - r).abs().max().item()
        scale = r.abs().max().item()
        errs.append(diff / scale if scale else (np.inf if diff else 0.0))
    stat = max([((got[2][k] - v).abs().max() / v.abs().max().clamp(min=1))
                .item() for k, v in ref[2].items()], default=0.0)
    return loss, max(errs), float(np.median(errs)), stat


def check_remedies_against_cpu():
    """Phase 9c: the card (kernels, ``highest`` precision) against the
    port's CPU (plain versions) on two small images, same weights and the
    same injected draws, for one remedy train step (warp, norms, blur,
    noise, block, GT expansion) and the remedy eval step.

    Train, with FrozenBatchNorm and with BatchNorm on batch statistics:
    the card rounds the warp's sample positions otherwise than the CPU
    (its warp of the same images differs by a measured eps), and its FFT
    blur sums otherwise; a ReLU near zero that such noise flips moves a
    coarse layer's gradient by up to a few percent, and BatchNorm on a
    from-scratch model's batch statistics makes the gradients chaotic
    besides. So the card's losses are held within 1e-4 relative and its
    gradients and statistics to 3x the CPU's own spread when the CPU's
    images are nudged by random noise of size eps, measured in this run.
    Eval (mode_one, dilation, blur, noise, block, JPEG, warp,
    norms; ``tests/torch_reference``'s random torchvision weights, taken
    as ``cli.evaluate --mode_one_norm`` takes a .pth): 85% of the CPU's
    valid detections matched per image, each image with some. The JPEG
    alone: its rounding jumps at .5 ties, so card and CPU agree on all but
    the blocks where a float32 DCT sum lands across one (printed)."""
    from detectinblur_tpu_torch.models.anchors import grid_anchors
    from detectinblur_tpu_torch.models.faster_rcnn import (
        Detections,
        FasterRCNN,
        FasterRCNNConfig,
        LossDraws,
    )
    from detectinblur_tpu_torch.ops.jpeg import jpeg_compress_decompress
    from detectinblur_tpu_torch.ops.psf import sample_psf
    from detectinblur_tpu_torch.ops.warp import squint_warp
    from detectinblur_tpu_torch.train.engine import (
        BlurBatch,
        derive_warp_params,
        make_eval_step,
    )
    from detectinblur_tpu_torch.train.estimator_engine import draw_corruptions
    from detectinblur_tpu_torch.utils.convert import params_from_torchvision
    from torch_reference import make_random_fasterrcnn_sd

    bucket, G = (128, 160), 5
    hw = np.array([[110, 150], [128, 100]])
    rng = np.random.default_rng(6)
    gen = torch.Generator().manual_seed(6)
    imgs = torch.from_numpy(rng.random((2, 128, 160, 3), np.float32))
    gt = np.zeros((2, G, 4), np.float32)
    gt[..., :2] = rng.uniform(0, 60, (2, G, 2))
    gt[..., 2:] = gt[..., :2] + rng.uniform(10, 50, (2, G, 2))
    batch = BlurBatch(
        images=imgs, hw=torch.from_numpy(hw),
        psfs=sample_psf(2, 0.005, 0.5, iters=500, generator=gen, device="cpu"),
        blurring=torch.tensor([True, True]), gt_boxes=torch.from_numpy(gt),
        gt_labels=torch.from_numpy(rng.integers(1, 91, (2, G))),
        gt_valid=torch.ones(2, G, dtype=torch.bool),
        param_index=torch.tensor([0, 0], dtype=torch.int32),
        fraction_index=torch.tensor([3, 3], dtype=torch.int32))
    shapes = [(bucket[0] // s, bucket[1] // s) for s in (4, 8, 16, 32)]
    shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
    A = sum(a.shape[0] for a in grid_anchors(tuple(shapes), bucket))
    cfg = FasterRCNNConfig(min_size=128, max_size=160, precision="highest",
                           warp_internally=True)
    PG = cfg.rpn.post_nms_top_n_train + G
    draws = LossDraws(rpn=(torch.rand(2, A, generator=gen),
                           torch.rand(2, A, generator=gen)),
                      roi=(torch.rand(2, PG, generator=gen),
                           torch.rand(2, PG, generator=gen)))
    cdraws = draw_corruptions(imgs, True, 0.001, True, True, gen)
    warped = derive_warp_params(batch)
    eps = max((squint_warp(imgs.to(dev), *(t.to(dev) for t in (
        warped.thetas, warped.lam1s, warped.lam2s))).cpu()
        - squint_warp(imgs, warped.thetas, warped.lam1s, warped.lam2s))
        .abs().max().item() for dev in ("cuda",))
    nudge = max(eps, 1e-6) * torch.randn(imgs.shape, generator=gen)

    run = lambda c, dev, **kw: _remedy_train_outputs(c, dev, batch, draws,
                                                     cdraws, **kw)
    names = ("max relative loss error", "gradient error / max |grad|, max",
             "median", "BatchNorm statistics error / magnitude")

    def show(what, errs):
        print(f"card vs CPU remedy train step, {what}: " + ", ".join(
            f"{n} {e:.3g}" for n, e in zip(names, errs)))
        return errs

    ok = True
    print(f"the card's warp of the images differs from the CPU's by eps "
          f"{eps:.3g}; the CPU's spread below nudges its images by that")
    for what, c in (("FrozenBatchNorm", cfg),
                    ("train-mode BatchNorm", cfg._replace(bn_mode="train"))):
        cpu = run(c, "cpu")
        card = show(f"warp, {what}", _train_errors(run(c, "cuda"), cpu))
        spread = show(f"the CPU's own spread, warp, {what}",
                      _train_errors(run(c, "cpu", nudge=nudge), cpu))
        ok &= card[0] <= 1e-4 and all(
            g <= 3 * sp for g, sp in zip(card[1:], spread[1:]))
    if not ok:
        sys.exit("the card's remedy train step disagrees with the CPU's")

    ecfg = cfg._replace(bn_mode="mode_one",
                        rpn=cfg.rpn._replace(pre_nms_top_n_test=400,
                                             post_nms_top_n_test=200),
                        box=cfg.box._replace(nms_pool=2048))
    sigma = torch.tensor([0.8, 2.4])
    sd = params_from_torchvision(make_random_fasterrcnn_sd(
        np.random.default_rng(0)), frozen_bn=False, num_batches=16.0)
    dets = {}
    for dev in ("cuda", "cpu"):
        model = FasterRCNN(ecfg, device=dev, seed=0)
        model.load_state_dict(sd)
        step = make_eval_step(model, bucket, **REMEDY_EVAL)
        dets[dev] = Detections(*(t.cpu() for t in step(
            model, batch, None, sigma, cdraws)[0]))
    shares = _match_share(dets["cuda"], dets["cpu"])
    jc = jpeg_compress_decompress(imgs.cuda(), cdraws.jpeg_quality.cuda()).cpu()
    jp = jpeg_compress_decompress(imgs, cdraws.jpeg_quality)
    close = ((jc - jp).abs() <= 2e-6).float().mean().item()
    print(f"card vs CPU remedy eval step on 2 small images: detections "
          f"matched {shares} (valid {dets['cpu'].valid.sum(1).tolist()}); "
          f"JPEG alone: {close:.4%} of values within 2e-6")
    if (min(shares) <= 0.85 or close < 0.9
            or min(dets["cpu"].valid.sum(1).tolist()) < 1):
        sys.exit("the card's remedy eval step disagrees with the CPU's")


def run_remedy_entry_points():
    """Phase 9d: the CLIs with the remedy flags on the synthetic COCO of
    phase 8. ``cli.train`` (3 steps, batch 2, from the random .pth, the BN
    unfolded) with --blur_train --warp_in_model --use_custom_image_norm
    --unfrozen_batch_norm --add_noise --add_block --add_jpeg_artefacts
    --non_pos_aug_mix: finite losses and evals, a checkpoint whose
    BatchNorm buffers come back bit for bit with a count of 3; then
    ``cli.evaluate`` on it, a one-param blur sweep (5 cells of 16 images)
    with --mode_one_norm --warp_in_model --use_custom_image_norm
    --dilate_psf and the three corruptions: 19 finite stats with
    detections scored in each cell, one forward launch per image. Each
    kernel is held against its plain version on the inputs each CLI
    handed it. Returns the launches per CLI."""
    import tempfile

    import detectinblur_tpu_torch.cli.evaluate as cli_eval
    import detectinblur_tpu_torch.cli.train as cli_train
    from detectinblur_tpu_torch.train.checkpoint import restore_checkpoint
    from detectinblur_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )

    flags = ["--warp_in_model", "--use_custom_image_norm", "--add_noise",
             "--add_block", "--add_jpeg_artefacts"]
    with tempfile.TemporaryDirectory() as tmp:
        root, pth = _phase8_files(tmp)
        out = str(Path(tmp) / "out")
        fwd, bwd = {}, {}
        t0 = time.perf_counter()
        with _capture_roi_align(fwd, bwd):
            run, train_launches = _counted(lambda: cli_train.main([
                "--data-path", root, "--blur_train", "--unfrozen_batch_norm",
                "--non_pos_aug_mix", *flags, "-b", "2", "--epochs", "1",
                "--early_stop", "3", "--output_dir", out, "--print-freq", "1",
                "--lr", "1e-5", "--start_from_weights", pth]))
        print(f"cli.train remedies: {time.perf_counter() - t0:.2f} s, launches "
              f"{train_launches}, losses " + json.dumps(run.losses))
        if _missed(train_launches):
            sys.exit("cli.train with the remedies did not launch every kernel")
        if len(run.losses) != 3 or not all(
                np.isfinite(v) for m in run.losses for v in m.values()):
            sys.exit("cli.train remedies: missing or non-finite losses")
        for tag, stats in sorted(run.evals.items()):
            stats = np.asarray(stats)
            print(f"cli.train remedies eval {tag}: 19 stats "
                  f"{np.round(stats, 4).tolist()}")
            if stats.shape != (19,) or not np.isfinite(stats).all():
                sys.exit(f"cli.train remedies eval {tag}: not 19 finite stats")
        check_captured("cli.train remedies", fwd, bwd)
        del fwd, bwd

        ckpt = Path(out) / "model_0.pt"
        model = cli_train.build_model(cli_train.train_parser().parse_args(
            ["--unfrozen_batch_norm", "--warp_in_model"]), "cuda")
        opt, _ = make_optimizer(model)
        restore_checkpoint(str(ckpt), create_train_state(model, opt))
        same = all(torch.equal(a, b) for a, b in zip(
            model.state_dict().values(), run.state.model.state_dict().values()))
        count = model.backbone.body.bn1.num_batches_tracked.item()
        print(f"{ckpt.name}: weights and BatchNorm buffers {same}, "
              f"num_batches_tracked {count}")
        if not same or count != 3.0:
            sys.exit("the remedy checkpoint did not come back bit for bit")
        del model, opt, run

        fwd = {}
        argv = ["--data-path", root, "--resume", str(ckpt), "--blur_eval",
                "--param_index", "1", "--mode_one_norm", "--dilate_psf", *flags]
        t0 = time.perf_counter()
        with _capture_roi_align(fwd, {}):
            results, eval_launches = _counted(lambda: cli_eval.main(argv))
        print(f"cli.evaluate remedies: {time.perf_counter() - t0:.2f} s, "
              f"launches {eval_launches}")
        if len(results) != 5:
            sys.exit(f"cli.evaluate remedies: {len(results)} cells, want 5")
        for cell, stats in sorted(results.items()):
            _check_stats(f"cli.evaluate remedies {cell}", stats)
        if eval_launches["roi_align_fwd"] != 16 * 5:
            sys.exit("cli.evaluate remedies: roi_align_fwd launched "
                     f"{eval_launches['roi_align_fwd']} times for 80 images")
        check_captured("cli.evaluate remedies", fwd, {})
    return {"cli_train_remedies": train_launches,
            "cli_evaluate_remedies": eval_launches}


# ------------------------------------------- deblur, estimator, ensemble
def msresnet_flops(net, h, w):
    """Floating-point operations (2 per multiply-add) of one MSResNet
    forward on an h x w image padded to /2^(scales-1), every conv of every
    scale at that scale's size."""
    div = 2 ** (net.n_scales - 1)
    h, w = -(-h // div) * div, -(-w // div) * div
    total = 0
    for name, m in net.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            s = int(name.split(".")[0][-1])
            cout, cin, kh, kw = m.weight.shape
            total += 2 * cin * cout * kh * kw * (h >> s) * (w >> s)
    return total


def run_deblur(gen):
    """Phase 10a: deblur-first's MSResNet at the full published size (3
    scales, 64 features, 19 blocks; ``synthetic_deepdeblur_state_dict``
    from seed 0) in float32 with TF32 off: ``deblur_image`` on phase 4's
    batch (8 x 480x640) and on one 832x1088 image, ms per image beside the
    bound (its FLOPs over the float32 peak); the card against the CPU on a
    1 x 64x96 image. Returns the timings."""
    from synthetic_torch import synthetic_deepdeblur_state_dict

    from detectinblur_tpu_torch.models.deblur import MSResNet, deblur_image
    from detectinblur_tpu_torch.utils.convert import deepdeblur_from_torch

    sd = deepdeblur_from_torch(synthetic_deepdeblur_state_dict())
    net = MSResNet.from_state_dict(sd).cuda().to(
        memory_format=torch.channels_last).eval()
    out = {}
    for name, (n, h, w) in (("batch 8 x 480x640", (B, *SRC_HW)),
                            ("1 x 832x1088", (1, 832, 1088))):
        x = torch.rand(n, h, w, 3, generator=gen).cuda()
        y = deblur_image(net, x)
        if y.shape != x.shape or not torch.isfinite(y).all() or not (
                (y >= 0) & (y <= 1)).all():
            sys.exit(f"deblur_image {name}: bad output")
        ms = _cuda_ms(lambda: deblur_image(net, x), 2) / n
        flops = msresnet_flops(net, h, w)
        out[name] = {"ms_per_image": ms, "tflop_per_image": flops / 1e12,
                     "bound_ms_per_image": flops / F32_OPS_PER_S * 1e3}
        print(f"deblur_image {name}: {ms:.2f} ms an image, bound "
              f"{flops / F32_OPS_PER_S * 1e3:.2f} ms ({flops / 1e12:.3f} "
              f"TFLOP an image, float32)")
        del x, y
    x = torch.rand(1, 64, 96, 3, generator=gen)
    cpu = deblur_image(MSResNet.from_state_dict(sd).eval(), x)
    err = (deblur_image(net, x.cuda()).cpu() - cpu).abs().max().item()
    print(f"deblur_image card vs CPU (1 x 64x96): max |difference| {err:.3g}, "
          f"tolerance 1e-4: {'ok' if err <= 1e-4 else 'FAILED'}")
    if err > 1e-4:
        sys.exit("the card's deblur disagrees with the CPU's")
    return out


def _estimator_batch(gen, n=B, hw=SRC_HW):
    """``n`` random images of size ``hw`` with camera-shake PSFs, 3 in 4
    blurred, random (type, exposure) indices (the labels), on the host."""
    from detectinblur_tpu_torch.ops.psf import sample_psf
    from detectinblur_tpu_torch.train.engine import BlurBatch

    rng = np.random.default_rng(1)
    blurring = torch.from_numpy(np.arange(n) % 4 != 3)
    return BlurBatch(
        images=torch.from_numpy(rng.random((n, *hw, 3), np.float32)),
        hw=torch.tensor([hw] * n),
        psfs=sample_psf(n, expl=0.005, fraction=0.5, generator=gen,
                        device="cpu"),
        blurring=blurring, gt_boxes=torch.zeros(n, 1, 4),
        gt_labels=torch.zeros(n, 1, dtype=torch.int64),
        gt_valid=torch.zeros(n, 1, dtype=torch.bool),
        param_index=torch.from_numpy(
            np.where(blurring, rng.integers(0, 3, n), -1).astype(np.int32)),
        fraction_index=torch.from_numpy(
            np.where(blurring, rng.integers(0, 5, n), -1).astype(np.int32)),
        est_label=torch.full((n,), -1, dtype=torch.int32))


ESTIMATOR_FLAGS = dict(label_smoothing=0.1, add_noise=True, add_block=True,
                       add_jpeg=True, quantize=True, resize_images=True,
                       crop_images=True)


def _estimator_step(n_classes, precision, device, bucket, flags):
    from detectinblur_tpu_torch.models.classifier import ResNetClassifier
    from detectinblur_tpu_torch.train.estimator_engine import (
        make_estimator_train_step,
    )
    from detectinblur_tpu_torch.train.state import (
        TrainState,
        make_lr_schedule,
    )

    model = ResNetClassifier("resnet18", n_classes, precision=precision,
                             device=device, seed=n_classes)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9,
                          weight_decay=1e-4)
    step = make_estimator_train_step(
        model, make_lr_schedule(0.01, 1, milestones=(6, 8)), bucket,
        lehe=n_classes == 4, **flags)
    return model, TrainState(0, model, opt), step


def run_estimator(gen):
    """Phase 10b: the blur estimator's train step, resnet18 to 16 classes
    and then 4 (LEHE), B=8 480x640 sources on the 832x1088 bucket,
    ``default`` precision, with the blur through the min-side-800 canvas
    (1600x1600), noise, block, JPEG, quantization, the crop and label
    smoothing 0.1: 3 steps must move every parameter (the BatchNorm
    affines too) and every running statistic; img/s from device time over
    3 more, peak memory. Then the card against the CPU on 2 x 64x96
    images (the noise and block draws shared; JPEG and quantization
    off): loss, gradients, statistics."""
    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
    from detectinblur_tpu_torch.train.estimator_engine import draw_corruptions

    bucket = model_bucket_for_batch([SRC_HW] * B)
    batch = _estimator_batch(gen)
    cuda_gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for n_classes in (16, 4):
        torch.cuda.reset_peak_memory_stats()
        model, state, step = _estimator_step(n_classes, "default", "cuda",
                                             bucket, ESTIMATOR_FLAGS)
        params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        stats0 = {k: v.clone() for k, v in model.state_dict().items()
                  if k.rpartition(".")[2] in BN_STATS}
        losses = []
        for _ in range(3):
            state, m = step(state, batch, generator=cuda_gen)
            losses.append(m["loss"].item())
        moved = sum(not torch.equal(p.detach(), params0[k])
                    for k, p in model.named_parameters())
        stats_moved = sum(not torch.equal(model.state_dict()[k], v)
                          for k, v in stats0.items())

        def one():
            nonlocal state
            state, _ = step(state, batch, generator=cuda_gen)
        ms = _cuda_ms(one, 3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"estimator {n_classes} classes: losses {losses}; parameters "
              f"moved {moved} of {len(params0)}, running statistics moved "
              f"{stats_moved} of {len(stats0)}; {ms:.2f} ms a step, "
              f"{B / ms * 1e3:.2f} img/s, peak {peak:.2f} GiB")
        if not all(np.isfinite(losses)) or moved != len(params0) or \
                stats_moved != len(stats0):
            sys.exit(f"estimator {n_classes}: non-finite loss, or a "
                     "parameter or statistic that did not move")
        out[n_classes] = {"img_s": B / ms * 1e3, "step_ms": ms,
                          "peak_gib": peak}
        del model, state, step

    # JPEG and the quantization round the image values, so the float noise
    # between cuFFT's and the CPU's blur flips some of their steps (a 1e-6
    # nudge moves the CPU's own gradients by up to 0.35 of a tensor's max
    # with them, 6e-5 without): the comparison leaves them out.
    small = _estimator_batch(gen, n=2, hw=(64, 96))
    draws = draw_corruptions(small.images, True, 0.001, True, False,
                             torch.Generator().manual_seed(4))
    continuous = dict(ESTIMATOR_FLAGS, add_jpeg=False, quantize=False)
    got = {}
    for dev in ("cuda", "cpu"):
        model, state, step = _estimator_step(4, "highest", dev, (64, 96),
                                             continuous)
        _, m = step(state, small, corruption_draws=draws)
        got[dev] = (m["loss"].item(),
                    {k: p.grad.cpu() for k, p in model.named_parameters()},
                    {k: v.cpu() for k, v in model.state_dict().items()
                     if k.rpartition(".")[2] in BN_STATS})
    (lc, gc, sc), (lp, gp, sp) = got["cuda"], got["cpu"]
    gerr = {k: ((gc[k] - gp[k]).abs().max() / gp[k].abs().max()).item()
            for k in gp}
    serr = max(((sc[k] - sp[k]).abs().max()
                / sp[k].abs().max().clamp(min=1)).item() for k in sp)
    ok = (abs(lc - lp) <= 1e-4 * abs(lp) and max(gerr.values()) <= 5e-2
          and float(np.median(list(gerr.values()))) <= 2e-3 and serr <= 1e-4)
    print(f"estimator step card vs CPU (2 x 64x96): loss {lc:.7g} vs "
          f"{lp:.7g}; gradients within {max(gerr.values()):.3g} of each "
          f"tensor's max (median {np.median(list(gerr.values())):.3g}), "
          f"statistics {serr:.3g}; tolerance loss 1e-4 relative, gradients "
          f"5e-2 (median 2e-3), statistics 1e-4: {'ok' if ok else 'FAILED'}")
    if not ok:
        sys.exit("the card's estimator step disagrees with the CPU's")
    return out


def run_ensemble_entry_points(keep):
    """Phase 10c: the CLIs of this slice on phase 8's synthetic COCO.
    ``cli.train_blur_estimator --LEHE_blur_seg`` (batch 2, 3 steps, the
    corruptions, quantization, --resize_images, --crop_images) must write
    a checkpoint that comes back bit for bit, running statistics included;
    then ``--test_only`` on it. ``cli.evaluate --use_ensemble --LEHE`` on
    four specialists (phase 8's ``model_0.pt`` in ``keep`` and
    ``tests/torch_reference`` weights at seeds 1-3) with that estimator
    and ``--deblur_first`` on the full synthetic MSResNet: clean (4
    images, so that the CPU rerun stays short) and a one-param sweep (5
    cells of 8 images); then an oracle sweep (no estimator, no deblur, 5
    cells of 8 images). Each eval must launch ``roi_align_fwd`` once per
    image and give 19 finite stats with detections scored; the kernel is
    held against its plain version on the inputs each eval handed it; the
    clean ensemble eval rerun on the CPU must give the card's 19 stats.
    Returns the launches per CLI and the eval loops' readings."""
    import tempfile

    import detectinblur_tpu_torch.cli.evaluate as cli_eval
    import detectinblur_tpu_torch.cli.train_blur_estimator as cli_est
    from detectinblur_tpu_torch.models.classifier import ResNetClassifier
    from detectinblur_tpu_torch.train import eval_loop
    from detectinblur_tpu_torch.train.checkpoint import restore_checkpoint
    from detectinblur_tpu_torch.train.state import TrainState
    from synthetic_torch import synthetic_deepdeblur_state_dict
    from torch_reference import make_random_fasterrcnn_sd

    loops, chosen = [], []

    def recorded_eval(*args, **kwargs):
        stats, loop = eval_loop.evaluate_coco(*args, **kwargs)
        loops.append(loop)
        return stats, loop

    def recording_predict(*args, **kwargs):
        predict = make_ensemble_predict(*args, **kwargs)

        def run(*a, **k):
            dets, gt, index = predict(*a, **k)
            chosen[-1].append(int(index))
            return dets, gt, index
        return run

    make_ensemble_predict = cli_eval.make_ensemble_predict
    cli_eval.evaluate_coco = recorded_eval
    cli_eval.make_ensemble_predict = recording_predict
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = _write_coco(str(tmp / "coco"))
        est_out = str(tmp / "estimator")
        t0 = time.perf_counter()
        run, n = _counted(lambda: cli_est.main([
            "--data-path", root, "--LEHE_blur_seg", "--add_noise",
            "--add_block", "--add_jpeg_artefacts", "--quantize_image",
            "--resize_images", "--crop_images", "--label_smoothing", "0.1",
            "-b", "2", "--epochs", "1", "--early_stop", "2",
            "--print-freq", "1", "--output_dir", est_out]))
        print(f"cli.train_blur_estimator: {time.perf_counter() - t0:.2f} s, "
              f"steps {run.state.step}, losses " + json.dumps(run.losses)
              + f", top-1 {run.top1}, top-2 {run.top2}")
        if run.state.step != 3 or not all(
                np.isfinite(v) for m in run.losses for v in m.values()):
            sys.exit("cli.train_blur_estimator: not 3 finite steps")
        ckpt = str(Path(est_out) / "model_0.pt")
        model = ResNetClassifier("resnet18", 4, device="cuda")
        state = restore_checkpoint(ckpt, TrainState(0, model, torch.optim.SGD(
            model.parameters(), lr=0.01, momentum=0.9)))
        same = all(torch.equal(v, model.state_dict()[k]) for k, v in
                   run.state.model.state_dict().items())
        print(f"estimator checkpoint: weights and running statistics {same}, "
              f"step {state.step}, count "
              f"{model.body.bn1.num_batches_tracked.item()}")
        if not same or state.step != 3:
            sys.exit("the estimator checkpoint did not come back bit for bit")
        del model, state, run
        test = cli_est.main(["--data-path", root, "--LEHE_blur_seg",
                             "--resize_images", "--crop_images",
                             "--test_only", "--resume", ckpt, "-b", "2",
                             "--output_dir", est_out])
        print(f"cli.train_blur_estimator --test_only: top-1 {test.top1}, "
              f"top-2 {test.top2}, confusion {test.confusion.tolist()}")
        launches["cli_train_blur_estimator"] = n

        paths = [str(keep / "model_0.pt")]
        for seed in (1, 2, 3):
            paths.append(str(tmp / f"specialist_{seed}.pth"))
            torch.save({k: torch.from_numpy(v) for k, v in
                        make_random_fasterrcnn_sd(
                            np.random.default_rng(seed)).items()}, paths[-1])
        deblur = str(tmp / "deepdeblur.pth")
        torch.save({k: torch.from_numpy(v) for k, v in
                    synthetic_deepdeblur_state_dict().items()}, deblur)
        ensemble = ["--data-path", root, "--use_ensemble",
                    "--ensemble_model_paths", *paths]
        gated = ensemble + ["--LEHE", "--blur_estimator_path", ckpt,
                            "--deblur_first", "--deblurer_model_location",
                            deblur]
        runs = (("clean", gated + ["--vanilla_eval", "--early_stop", "4"],
                 1, 4),
                ("sweep P1", gated + ["--blur_eval", "--param_index", "1",
                                      "--early_stop", "8"], 5, 8),
                ("oracle sweep P2", ensemble + ["--blur_eval",
                                                "--param_index", "2",
                                                "--early_stop", "8"], 5, 8))
        for name, argv, cells, images in runs:
            path = f"cli.evaluate ensemble {name}"
            fwd, chosen[:] = {}, [[]]
            t0 = time.perf_counter()
            with _capture_roi_align(fwd, {}):
                got, n = _counted(lambda: cli_eval.main(argv))
            results = {0: got} if cells == 1 else got
            print(f"{path}: {time.perf_counter() - t0:.2f} s, launches {n}, "
                  f"specialists chosen {np.bincount(chosen[0], minlength=4).tolist()}"
                  f" (first images {chosen[0][:10]})")
            if len(results) != cells:
                sys.exit(f"{path}: {len(results)} cells, want {cells}")
            for cell, stats in sorted(results.items()):
                _check_stats(f"{path} {cell}", stats)
            if n["roi_align_fwd"] != cells * images:
                sys.exit(f"{path}: roi_align_fwd launched {n['roi_align_fwd']}"
                         f" times for {cells * images} images")
            check_captured(path, fwd, {})
            launches[path.replace(" ", "_").replace(".", "_")] = n
            if name == "clean":
                card = got
        t0 = time.perf_counter()
        cpu = cli_eval.main(runs[0][1] + ["--device", "cpu"])
        err = np.abs(np.asarray(card) - cpu)
        dets = [loops[0]["detections"], loops[-1]["detections"]]
        ok = bool(((err <= 1e-3) & (err <= 1e-3 * np.abs(cpu) + 1e-7)).all()
                  ) and abs(dets[0] - dets[1]) <= 0.02 * dets[1]
        print(f"card vs CPU clean ensemble eval ({time.perf_counter() - t0:.2f}"
              f" s on the CPU): max |stat difference| {err.max():.3g}, "
              f"tolerance 1e-3 and 1e-3 of each stat; detections {dets[0]} vs "
              f"{dets[1]}, tolerance 2%: {'ok' if ok else 'FAILED'}")
        if not ok:
            sys.exit("the card's ensemble eval disagrees with the CPU's")
    cli_eval.make_ensemble_predict = make_ensemble_predict
    for s in loops:
        print("eval loop " + json.dumps(s))
    return launches, [{k: s[k] for k in ("images", "img_s", "wall_s",
                                          "step_ms_per_image")}
                      for s in loops[:-1]]


# ------------------------------------------------ single-map detectors
SINGLE_MAP = (("mobile_net", "mobile_net"), ("resnet_50", "resnet50"))


def _single_map(torso, precision="default", device="cuda", zero_deltas=True,
                imagenet=False, **kw):
    """A single-map detector at full width, random weights from seed 0;
    with ``imagenet`` its torso from ``tests/torso_weights.py``'s random
    He-scaled torchvision classifier (seed 0 for mobilenet_v2, 1 for
    resnet50; a fresh MobileNetV2 on running statistics passes almost no
    signal through its 17 linear bottlenecks), as ``--pretrained`` loads
    an ImageNet one; with ``zero_deltas`` the RPN delta head is zero, so
    that proposals sit at the anchors (bench.py:90-103, as phase 4)."""
    from detectinblur_tpu_torch.models.backbones import (
        SingleMapConfig,
        SingleMapFasterRCNN,
    )
    from detectinblur_tpu_torch.utils.convert import torso_from_torchvision
    from torso_weights import mobilenet_sd, resnet_sd

    model = SingleMapFasterRCNN(SingleMapConfig(torso, precision=precision,
                                                **kw), device=device)
    if imagenet:
        sd = mobilenet_sd() if torso == "mobile_net" else resnet_sd(torso)
        model.load_state_dict({**model.state_dict(),
                               **torso_from_torchvision(sd, torso)})
    if zero_deltas:
        with torch.no_grad():
            model.rpn_head.bbox_pred.weight.zero_()
            model.rpn_head.bbox_pred.bias.zero_()
    return model


def _single_geom(boxes, feats):
    from detectinblur_tpu_torch.ops.roi_align import roi_geometry

    return roi_geometry(boxes.reshape(-1, 4), [feats[0].shape[1:3]],
                        spatial_scale=1 / 32)


def run_single_map_serving(torso, gen):
    """Phase 11a: blur + ``predict`` of B=8 480x640 images in the CLIs'
    bucket (832x1088; the model resizes to 300x400 inside it) at full
    width, ``default`` precision, the torso from a random torchvision
    classifier (``_single_map``), the class scores x4 (doubled up to x64
    until every image has a box above 0.05: blurred noise gives the
    resnet50 torso flat features), so that random heads score
    boxes. The counted run must launch the forward kernel and score a box
    on every image; the kernel is held against its plain version on the rois and
    the map the run handed it, in bfloat16 and float32, and timed there
    against its bytes bound. Returns (launches, timing, summary)."""
    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
    from detectinblur_tpu_torch.ops.blur import batched_blur
    from detectinblur_tpu_torch.ops.psf import sample_psf
    from detectinblur_tpu_torch.ops.roi_align_cuda import (
        roi_align_single_level_cuda,
    )

    hw = np.tile(np.asarray([SRC_HW]), (B, 1))
    bucket = model_bucket_for_batch(hw)
    model = _single_map(torso, imagenet=True)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((B, *SRC_HW, 3), np.float32)).cuda()
    psfs = sample_psf(B, expl=0.005, fraction=0.5, generator=gen,
                      device="cuda")
    blurring = torch.ones(B, dtype=torch.bool, device="cuda")

    def blur_detect():
        blurred = batched_blur(images.permute(0, 3, 1, 2), psfs, blurring)
        return model.predict(blurred.permute(0, 2, 3, 1), hw, bucket)

    scale = 1
    for factor in (4, 2, 2, 2, 2):   # random heads score no box at first
        scale *= factor
        with torch.no_grad():
            model.box_predictor.cls_score.weight.mul_(factor)
        if blur_detect().valid.sum(1).min() > 0:
            break
    fwd = {}
    with _capture_roi_align(fwd, {}), _capture_nms(
            f"single_map_{torso}_serving"), _eager_predict():
        blur_detect()
    det, launches = _counted(blur_detect)
    print(f"single-map {torso} serving: bucket {bucket}, class scores x"
          f"{scale}, launches {launches}")
    if launches["roi_align_fwd"] == 0 or launches["nms_alive"] == 0:
        sys.exit(f"single-map {torso} serving never launched roi_align_fwd "
                 f"or nms_alive")
    if det.boxes.shape != (B, 100, 4) or not (
            torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()):
        sys.exit(f"single-map {torso}: bad detections {det.boxes.shape}")
    if det.valid.sum(1).min() == 0:
        sys.exit(f"single-map {torso} serving scored no box on an image "
                 f"with the class scores x{scale}: {det.valid.sum(1).tolist()}")

    torch.cuda.reset_peak_memory_stats()
    windows, iters = 5, 3
    rates = [B * iters / (_cuda_ms(blur_detect, iters) * iters / 1e3)
             for _ in range(windows)]
    img_s = sorted(rates)[(windows - 1) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    (boxes, feats), = fwd.values()
    for dt in (torch.bfloat16, torch.float32):
        f = feats[0].to(dt)
        with torch.no_grad():
            _hold(f"single-map {torso} serving: roi_align_fwd {_name(dt)} at "
                  f"{tuple(boxes.shape)} rois on the {tuple(f.shape)} map",
                  roi_align_single_level_cuda(f, boxes, 1 / 32),
                  roi_align_from_geometry_single(f, boxes),
                  bf16_rounded=dt == torch.bfloat16)
    timing = time_fwd_kernel(feats, _single_geom(boxes, feats),
                             boxes.shape[1],
                             f"single-map {torso} serving rois")
    summary = {"img_s": img_s, "window_img_s": rates, "peak_mem_gib": peak,
               "map": list(feats[0].shape), "class_score_scale": scale,
               "valid_detections": det.valid.sum(1).tolist()}
    print(f"single-map {torso} serving " + json.dumps(summary))
    return launches, timing, summary


def roi_align_from_geometry_single(feat, boxes):
    """The plain single-level RoIAlign of [B, R, 4] ``boxes`` on ``feat``
    [B, H, W, C] at 1/32 -> [B, R, 7, 7, C]."""
    from detectinblur_tpu_torch.ops.roi_align import roi_align_from_geometry

    out = roi_align_from_geometry([feat], _single_geom(boxes, [feat]),
                                  boxes.shape[1])
    return out.reshape(*boxes.shape[:2], *out.shape[1:])


def run_single_map_train(torso, gen):
    """Phase 11b: the train step (bench_train.py's protocol: B=8, 16 GT
    boxes, blur and GT expansion, lr 0.04 from scratch, ``default``) of a
    single-map detector. The counted step must launch both kernels, keep
    its losses finite and move every parameter (nothing is frozen outside
    ``backbone.body``: the FrozenBatchNorm affines of resnet50 train) and,
    for MobileNetV2, every running statistic. The backward kernel is held
    against its plain version on the step's cotangent (bfloat16, and the
    same in float32) and timed against its bound. Returns (launches,
    the backward's timing entry, summary)."""
    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
    from detectinblur_tpu_torch.ops.roi_align import (
        roi_align_backward_from_geometry,
    )
    from detectinblur_tpu_torch.ops.roi_align_cuda import roi_align_bwd
    from detectinblur_tpu_torch.train.engine import make_train_step
    from detectinblur_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )

    bucket = model_bucket_for_batch([SRC_HW] * B)
    model = _single_map(torso, zero_deltas=False)
    opt, schedule = make_optimizer(model, base_lr=0.04, steps_per_epoch=1000)
    state = create_train_state(model, opt)
    step = make_train_step(model, schedule, bucket, blur_train=True,
                           expand_target_boxes=True)
    batch = _train_batch(gen)
    state, _ = step(state, batch, generator=gen)
    fwd, bwd = {}, {}
    with _capture_roi_align(fwd, bwd), _capture_nms(
            f"single_map_{torso}_train_step"):
        state, _ = step(state, batch, generator=gen)
    torch.cuda.synchronize()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    (state, metrics), launches = _counted(
        lambda: step(state, batch, generator=gen))
    print(f"single-map {torso} train step: launches {launches}, losses "
          + json.dumps({k: v.item() for k, v in metrics.items()}))
    if _missed(launches):
        sys.exit(f"the single-map {torso} train step did not launch every "
                 "kernel")
    if not all(torch.isfinite(v) for v in metrics.values()):
        sys.exit(f"non-finite single-map {torso} training loss")
    params = {n for n, _ in model.named_parameters()}
    trainable = {n for g in opt.param_groups for p in g["params"]
                 for n, q in model.named_parameters() if q is p}
    moved = {k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])}
    stats = {k for k in before if k.rpartition(".")[2] in BN_STATS}
    print(f"single-map {torso} train step: {len(moved & params)} of "
          f"{len(params)} parameters moved ({len(trainable)} trainable), "
          f"{len(moved & stats)} of {len(stats)} BatchNorm buffers")
    if trainable != params or moved != params | stats:
        sys.exit(f"the single-map {torso} train step moved the wrong "
                 f"tensors: {sorted((params | stats) ^ moved)[:5]}")
    del before

    torch.cuda.reset_peak_memory_stats()
    windows, iters = 3, 3
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

    (boxes, feats), = fwd.values()
    time_fwd_kernel(feats, _single_geom(boxes, feats), boxes.shape[1],
                    f"single-map {torso} train rois")
    captured, = bwd.values()
    dout, geom, R, shapes, out_dtype = captured
    errs = {}
    for dt in (dout.dtype, torch.float32):
        d = dout.to(dt)
        errs[dt] = _hold(
            f"single-map {torso} train step: roi_align_bwd {_name(dt)} "
            f"cotangent at {d.shape[0] // R} x {R} rois on the "
            f"{tuple(shapes[0])} map of {d.shape[-1]} channels",
            roi_align_bwd(d, geom, R, shapes),
            roi_align_backward_from_geometry(d, geom, R, shapes))
    entry = time_bwd_kernel(captured, launches["roi_align_bwd"], errs,
                            f"the single-map {torso} train step's")
    summary = {"img_s": img_s, "window_img_s": rates, "peak_mem_gib": peak}
    print(f"single-map {torso} train " + json.dumps(summary))
    return launches, entry, summary


def check_single_map_against_cpu():
    """Phase 11c, ``highest`` precision, the card (kernels) against the
    port's CPU (plain versions): mobile_net's loss and gradients on 2
    images of 256x320 with the sampler draws injected and the RPN's
    prediction layers fixed (proposals at the anchors on both devices):
    losses within 1e-4 relative; each gradient within 0.25 of its max,
    the heads' within 5e-2, the whole gradient within 2e-2 in L2 (the
    limits of ``tests/test_torch_port_backbones.py``: BatchNorm on batch
    statistics is ill-conditioned at every size, see
    ``tests/gradient_conditioning.py``), and each within 3x the card's own
    spread under a 1e-6 nudge of the images or within 1e-3 of its max,
    their median no larger than the nudge's (at least 2e-3). Then
    resnet_50's predict on 2 small
    images (5 classes, predictor x4 so that random weights score): C5
    within 2e-3 of its max, 85% of the CPU's detections matched by label,
    IoU > 0.95 and score within 2e-3."""
    from detectinblur_tpu_torch.models.faster_rcnn import LossDraws

    bucket, G = (256, 320), 5
    kw = dict(min_size=256, max_size=320, num_classes=5)
    hw = np.array([[240, 320], [256, 200]])
    rng = np.random.default_rng(6)
    imgs = rng.random((2, *bucket, 3), np.float32)
    gt = np.zeros((2, G, 4), np.float32)
    gt[..., :2] = rng.uniform(0, 150, (2, G, 2))
    gt[..., 2:] = gt[..., :2] + rng.uniform(40, 120, (2, G, 2))
    labels = torch.from_numpy(rng.integers(1, 5, (2, G)))
    valid = torch.ones(2, G, dtype=torch.bool)
    A = 15 * (bucket[0] // 32) * (bucket[1] // 32)
    PG = 2000 + G
    g = torch.Generator().manual_seed(5)
    draws = LossDraws(rpn=(torch.rand(2, A, generator=g),
                           torch.rand(2, A, generator=g)),
                      roi=(torch.rand(2, PG, generator=g),
                           torch.rand(2, PG, generator=g)))
    nudge = np.float32(1e-6) * rng.standard_normal(imgs.shape).astype(
        np.float32)

    def grads(dev, images):
        model = _single_map("mobile_net", "highest", dev, **kw)
        with torch.no_grad():
            model.rpn_head.cls_logits.weight.zero_()
            model.rpn_head.cls_logits.bias.copy_(
                torch.linspace(-0.3, 0.3, 15) + 0.01)
        losses = model.loss(torch.from_numpy(images), hw,
                            torch.from_numpy(gt), labels, valid, bucket,
                            draws=LossDraws(*(tuple(t.to(dev) for t in d)
                                              for d in draws)))
        sum(losses.values()).backward()
        return ({k: v.item() for k, v in losses.items()},
                {n: p.grad.cpu() for n, p in model.named_parameters()})

    (card_l, card_g), n = _counted(lambda: grads("cuda", imgs))
    if _missed(n):
        sys.exit("the card's single-map loss did not launch both kernels")
    _, nudged_g = grads("cuda", imgs + nudge)
    cpu_l, cpu_g = grads("cpu", imgs)
    top = max(v.abs().max().item() for v in cpu_g.values())
    rel = lambda a, b, k: ((a - b).abs().max().item()
                           / max(cpu_g[k].abs().max().item(), 1e-5 * top))
    err = {k: rel(card_g[k], cpu_g[k], k) for k in cpu_g}
    spread = {k: rel(nudged_g[k], card_g[k], k) for k in cpu_g}
    loss_err = max(abs(card_l[k] - v) / abs(v) for k, v in cpu_l.items())
    bad = {k: (e, spread[k]) for k, e in err.items()
           if not e <= max(3 * spread[k], 1e-3)}
    heads = max(e for k, e in err.items() if not k.startswith("backbone."))
    l2 = (sum(float(((card_g[k] - cpu_g[k]).double() ** 2).sum())
              for k in cpu_g)
          / sum(float((cpu_g[k].double() ** 2).sum()) for k in cpu_g)) ** 0.5
    print(f"card vs CPU single-map mobile_net loss (2 x 256x320): losses "
          f"{cpu_l}, max relative loss error {loss_err:.3g}; gradient error "
          f"/ max |grad|: median {np.median(list(err.values())):.3g}, max "
          f"{max(err.values()):.3g}, the heads' max {heads:.3g}, L2 of the "
          f"whole gradient {l2:.3g}; the card's own under a 1e-6 nudge: "
          f"median {np.median(list(spread.values())):.3g}, max "
          f"{max(spread.values()):.3g}; outside 3x the nudge and 1e-3: "
          f"{len(bad)}; tolerance 0.25 a tensor, 5e-2 the heads, 2e-2 L2")
    if loss_err > 1e-4 or bad or max(err.values()) > 0.25 or heads > 5e-2 \
            or l2 > 2e-2 or np.median(list(err.values())) > max(
                np.median(list(spread.values())), 2e-3):
        sys.exit(f"the card's single-map loss or gradients disagree with "
                 f"the CPU's: {sorted(bad.items())[:3]}")

    hw = np.array([[110, 150], [128, 100]])
    imgs = torch.from_numpy(rng.random((2, 128, 160, 3), np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        model = _single_map("resnet50", "highest", dev, min_size=128,
                            max_size=160, num_classes=5)
        with torch.no_grad():
            model.box_predictor.cls_score.weight.mul_(4)
            batched, _ = model.preprocess(imgs.to(dev), hw, (128, 160))
            c5, = model.features(batched)
            out[dev] = c5.float().cpu(), model.predict(imgs, hw, (128, 160))
    c5_err = ((out["cuda"][0] - out["cpu"][0]).abs().max()
              / out["cpu"][0].abs().max()).item()
    got = type(out["cpu"][1])(*(t.cpu() for t in out["cuda"][1]))
    shares = _match_share(got, out["cpu"][1])
    n_det = out["cpu"][1].valid.sum(1).tolist()
    print(f"card vs CPU single-map resnet_50 predict: C5 max err / max "
          f"{c5_err:.3g}, detections {n_det}, matched {shares}")
    if c5_err > 2e-3 or min(shares) <= 0.85 or min(n_det) < 1:
        sys.exit("the card's single-map predict disagrees with the CPU's")


def _scoring_heads(model):
    """Random heads that score phase 11d's COCO: the class scores x4 and
    the logits of its 4 categories +3 (random heads put nearly all their
    boxes on two or three classes of 90 otherwise)."""
    with torch.no_grad():
        model.box_predictor.cls_score.weight.mul_(4)
        model.box_predictor.cls_score.bias[1:5] += 3
    return model


def run_single_map_entry_points():
    """Phase 11d, the entry points with the single-map detectors and the
    natural-blur data. On a synthetic COCO of phase 8's writer with 4
    categories and boxes of 10-60% of a side: ``cli.train --model
    mobile_net`` (batch 2, 3 steps, lr 1e-5, from a start checkpoint: the
    He-scaled MobileNetV2 torso of ``tests/torso_weights.py`` and the
    port's random heads made to score, ``_scoring_heads``) must launch
    both kernels and write a ``model_0.pt`` that gives back weights,
    momentum, step and running statistics bit for bit; ``cli.evaluate
    --model mobile_net`` on it (4 images) must match a box (AP > 0) and
    give the CPU's 19 stats; ``cli.evaluate --model resnet_50`` from a
    start checkpoint made as mobile_net's must match a box, and from the
    He-scaled resnet50 ``.pth`` it was made from (its torso; the random
    heads made to score as in the checkpoint) give the same stats. On a
    synthetic GOPRO sequence at GOPRO's 720x1280 (13 frames with DORS dumps and flows,
    ``tests/synthetic_gopro.py``): ``dataset_tools render-gopro-synth
    --window 2 --expand_boxes``, ``segment-gopro``, then ``cli.evaluate
    --blurred_dataset GOPROSynth --expand_synth_boxes`` (3 images) and
    ``--blurred_dataset GOPROSynthLoad`` on the rendered set (9), and
    ``cli.train_blur_estimator --dataset GOPROBlurEst --LEHE_blur_seg``
    (3 steps). Each eval launches ``roi_align_fwd`` once per image, gives
    19 finite stats, and each kernel is held against its plain version on
    the inputs it was handed. Returns the launches per CLI."""
    import shutil

    import detectinblur_tpu_torch.cli.dataset_tools as tools
    import detectinblur_tpu_torch.cli.evaluate as cli_eval
    import detectinblur_tpu_torch.cli.train as cli_train
    import detectinblur_tpu_torch.cli.train_blur_estimator as cli_est
    from detectinblur_tpu_torch.train import eval_loop
    from synthetic_gopro import write_gopro
    from torso_weights import mobilenet_sd, resnet_sd

    loops = []

    def recorded_eval(*args, **kwargs):
        stats, loop = eval_loop.evaluate_coco(*args, **kwargs)
        loops.append(loop)
        return stats, loop

    cli_train.evaluate_coco = cli_eval.evaluate_coco = recorded_eval
    launches = {}
    save = lambda sd, path: torch.save(
        {k: torch.from_numpy(v) for k, v in sd.items()}, path)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        root = _write_coco(str(tmp / "coco"), n_cats=4, box_frac=(0.1, 0.6))
        save(mobilenet_sd(), tmp / "mobilenet_v2.pth")
        save(resnet_sd("resnet50"), tmp / "resnet50.pth")
        parse = cli_train.train_parser().parse_args
        for flag, pth in (("mobile_net", "mobilenet_v2.pth"),
                          ("resnet_50", "resnet50.pth")):
            start = cli_train.load_initial_params(
                parse(["--model", flag, "--start_from_weights",
                       str(tmp / pth)]),
                cli_train.build_model(parse(["--model", flag]), "cuda"))
            _scoring_heads(start)
            torch.save(start.state_dict(), tmp / f"{flag}_start.pt")
        del start
        gopro = write_gopro(str(tmp / "gopro"), [("train", 13)],
                            hw=(720, 1280), seed=0, box_frac=(0.2, 0.6))
        rendered = str(tmp / "rendered")
        tools.main(["render-gopro-synth", "--root_dir", gopro,
                    "--output_dir", rendered, "--window", "2",
                    "--expand_boxes"])
        tools.main(["segment-gopro", "--root_dir", rendered])
        print(f"phase 11d data (COCO, weights, GOPRO 720x1280 x 13 frames, "
              f"rendered and split): {time.perf_counter() - t0:.2f} s")

        out = tmp / "out"
        fwd, bwd = {}, {}
        t0 = time.perf_counter()
        with _capture_roi_align(fwd, bwd):
            run, n = _counted(lambda: cli_train.main([
                "--data-path", root, "--model", "mobile_net", "--blur_train",
                "--expand_target_boxes", "-b", "2", "--epochs", "1",
                "--early_stop", "3", "--output_dir", str(out),
                "--print-freq", "1", "--lr", "1e-5", "--start_from_weights",
                str(tmp / "mobile_net_start.pt")]))
        print(f"cli.train --model mobile_net: {time.perf_counter() - t0:.2f} "
              f"s, launches {n}, losses " + json.dumps(run.losses))
        if _missed(n) or len(run.losses) != 3 or not all(
                np.isfinite(v) for m in run.losses for v in m.values()):
            sys.exit("cli.train --model mobile_net: no launch, or missing or "
                     "non-finite losses")
        check_captured("cli.train --model mobile_net", fwd, bwd)
        launches["cli_train_mobile_net"] = n
        ckpt = str(out / "model_0.pt")
        model = cli_train.build_model(parse(["--model", "mobile_net"]),
                                      "cuda")
        same = _same_checkpoint(ckpt, run, model)
        count = model.backbone.stem_bn.num_batches_tracked.item()
        print(f"running statistics' count {count}")
        if not (same and run.state.step == 3 and count == 3.0):
            sys.exit("the mobile_net checkpoint did not come back bit for bit")
        del model, run

        r50 = ["--data-path", root, "--model", "resnet_50", "--vanilla_eval",
               "--early_stop", "4", "--start_from_weights"]
        evals = (
            ("mobile_net clean", ["--data-path", root, "--model", "mobile_net",
                                  "--resume", ckpt, "--vanilla_eval",
                                  "--early_stop", "4"], 4),
            ("resnet_50 clean, torso .pth", r50 + [str(tmp / "resnet50.pth")],
             4),
            ("resnet_50 clean", r50 + [str(tmp / "resnet_50_start.pt")], 4),
            ("mobile_net GOPROSynth expanded", [
                "--data-path", gopro, "--model", "mobile_net", "--resume",
                ckpt, "--blurred_dataset", "GOPROSynth",
                "--expand_synth_boxes"], 3),
            ("mobile_net GOPROSynthLoad", [
                "--data-path", rendered, "--model", "mobile_net", "--resume",
                ckpt, "--blurred_dataset", "GOPROSynthLoad"], 9))
        build = cli_eval.build_model

        def scoring_build(args, device):
            # The torso .pth leaves the heads random: made to score as the
            # start checkpoint's, so that the two resnet_50 evals agree.
            return _scoring_heads(build(args, device))

        results = {}
        for name, argv, images in evals:
            path = f"cli.evaluate {name}"
            fwd, n_loops = {}, len(loops)
            cli_eval.build_model = (scoring_build if name.endswith(".pth")
                                    else build)
            t0 = time.perf_counter()
            with _capture_roi_align(fwd, {}):
                stats, n = _counted(lambda: cli_eval.main(argv))
            cli_eval.build_model = build
            print(f"{path}: {time.perf_counter() - t0:.2f} s, launches {n}, "
                  f"images {loops[-1]['images']}, detections "
                  f"{loops[-1]['detections']}")
            _check_stats(path, stats)
            if n["roi_align_fwd"] != images or loops[-1]["images"] != images:
                sys.exit(f"{path}: roi_align_fwd launched "
                         f"{n['roi_align_fwd']} times for {images} images")
            check_captured(path, fwd, {})
            launches[path.replace(" ", "_").replace(".", "_")] = n
            results[name] = stats, loops[n_loops]["detections"]
        for name in ("mobile_net clean", "resnet_50 clean"):
            if not results[name][0][0] > 0:
                sys.exit(f"cli.evaluate {name}: AP {results[name][0][0]}, "
                         "no box matched: nothing to compare")
        err = np.abs(np.asarray(results["resnet_50 clean, torso .pth"][0])
                     - results["resnet_50 clean"][0])
        print(f"cli.evaluate --model resnet_50 from the torso .pth against "
              f"the start checkpoint of the same weights: max |stat "
              f"difference| {err.max():.3g}, tolerance 1e-3")
        if err.max() > 1e-3:
            sys.exit("cli.evaluate --model resnet_50 loads the torso .pth "
                     "into other weights than the start checkpoint")
        card, card_dets = results["mobile_net clean"]
        t0 = time.perf_counter()
        cpu = cli_eval.main(evals[0][1] + ["--device", "cpu"])
        err = np.abs(np.asarray(card) - cpu)
        cpu_dets = loops[-1]["detections"]
        ok = bool(((err <= 1e-3) & (err <= 1e-3 * np.abs(cpu) + 1e-7)).all()
                  ) and abs(card_dets - cpu_dets) <= 0.02 * max(cpu_dets, 1)
        print(f"card vs CPU cli.evaluate --model mobile_net "
              f"({time.perf_counter() - t0:.2f} s on the CPU): max |stat "
              f"difference| {err.max():.3g}, tolerance 1e-3 and 1e-3 of each "
              f"stat; detections {card_dets} vs {cpu_dets}, tolerance 2%: "
              f"{'ok' if ok else 'FAILED'}")
        if not ok or cpu_dets == 0:
            sys.exit("the card's mobile_net eval disagrees with the CPU's")

        t0 = time.perf_counter()
        est_out = str(tmp / "estimator")
        run, n = _counted(lambda: cli_est.main([
            "--data-path", rendered, "--dataset", "GOPROBlurEst",
            "--LEHE_blur_seg", "-b", "2", "--epochs", "1", "--early_stop",
            "2", "--print-freq", "1", "--output_dir", est_out]))
        print(f"cli.train_blur_estimator --dataset GOPROBlurEst: "
              f"{time.perf_counter() - t0:.2f} s, steps {run.state.step}, "
              f"losses " + json.dumps(run.losses) + f", top-1 {run.top1}, "
              f"confusion {run.confusion.tolist()}")
        if run.state.step != 3 or not all(
                np.isfinite(v) for m in run.losses for v in m.values()):
            sys.exit("cli.train_blur_estimator --dataset GOPROBlurEst: not 3 "
                     "finite steps")
    for s in loops:
        print("eval loop " + json.dumps(s))
    return launches


# ------------------------------------- person keypoints, tools, profiling
def _scoring_pth(sd):
    """A torchvision-layout detector state dict whose random heads score:
    the class scores x4 and the foreground logits +3, as
    ``_scoring_heads`` makes a model's."""
    sd = dict(sd)
    sd["roi_heads.box_predictor.cls_score.weight"] = (
        sd["roi_heads.box_predictor.cls_score.weight"] * 4)
    bias = sd["roi_heads.box_predictor.cls_score.bias"].copy()
    bias[1:5] += 3
    sd["roi_heads.box_predictor.cls_score.bias"] = bias
    return sd


def _same_checkpoint(ckpt, run, model):
    """Whether ``ckpt`` restores ``run``'s weights and buffers (running
    statistics included), momentum buffers and step bit for bit into
    ``model`` (a fresh build of the same detector)."""
    from detectinblur_tpu_torch.train.checkpoint import restore_checkpoint
    from detectinblur_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )

    opt, _ = make_optimizer(model)
    state = restore_checkpoint(str(ckpt), create_train_state(model, opt))
    same = all(torch.equal(v, model.state_dict()[k]) for k, v in
               run.state.model.state_dict().items())
    bufs = lambda o: [o.state[p]["momentum_buffer"]
                      for g in o.param_groups for p in g["params"]]
    same_m = len(bufs(opt)) == len(bufs(run.state.optimizer)) > 0 and all(
        torch.equal(a, b) for a, b in zip(bufs(opt),
                                          bufs(run.state.optimizer)))
    print(f"{Path(ckpt).name} ({Path(ckpt).stat().st_size} bytes): weights "
          f"and buffers {same}, momentum {same_m}, step {state.step} == "
          f"{run.state.step}")
    return same and same_m and state.step == run.state.step


def check_psf_bank(root, per):
    """Phase 12a's checks of a stored bank: every file fp16 128x128, its
    support inside the central 128x128 window (``see_PSFs.py``), each
    PSF's mass its folder's exposure fraction within 0.02, and the bank
    read back by ``load_psf_bank`` equal to the files."""
    from detectinblur_tpu_torch.data.blur_sampling import load_psf_bank
    from detectinblur_tpu_torch.ops.psf import BLUR_FRACTIONS

    bank = load_psf_bank(str(root))
    if bank.shape != (3, 5, per, 128, 128):
        sys.exit(f"load_psf_bank: shape {bank.shape}")
    worst = 0.0
    for pi in range(3):
        for fi, fraction in enumerate(BLUR_FRACTIONS):
            for i in range(per):
                with open(root / f"P{pi + 1}E{fi}" / f"I{i:06d}", "rb") as f:
                    psf = np.load(f)
                if psf.dtype != np.float16 or psf.shape != (128, 128):
                    sys.exit(f"P{pi + 1}E{fi}/I{i:06d}: {psf.dtype} "
                             f"{psf.shape}, want float16 (128, 128)")
                ys, xs = np.nonzero(psf > 0)
                c = psf.shape[0]
                lo, hi = c // 2 - 64, c // 2 + 64
                if len(ys) and (ys.min() < lo or ys.max() >= hi
                                or xs.min() < lo or xs.max() >= hi):
                    sys.exit(f"P{pi + 1}E{fi}/I{i:06d}: support exceeds the "
                             "central 128 window")
                if not np.array_equal(bank[pi, fi, i], psf.astype(np.float32)):
                    sys.exit(f"load_psf_bank differs from P{pi + 1}E{fi}/"
                             f"I{i:06d}")
                worst = max(worst, abs(float(psf.astype(np.float64).sum())
                                       - fraction))
    print(f"PSF bank {bank.shape}: fp16 files, support in the central "
          f"window, max |mass - exposure fraction| {worst:.3g} (tolerance "
          "0.02)")
    if worst > 0.02:
        sys.exit("a stored PSF's mass is not its exposure fraction")


def run_keypoint_entry_points():
    """Phase 12: ``cli.generate_psfs`` on the card (128 PSFs a folder, the
    published canvas 256, max_len 96, crop 128 and batch 128), its bank
    checked and read back; ``cli.train --dataset coco_kp`` from that bank
    on a synthetic person-keypoint COCO at full width (2 classes) and
    ``cli.evaluate --dataset coco_kp`` on its checkpoint, clean and with
    ``--image_output_dir``, against the CPU; then one eval step timed
    with ``utils/profiling.step_timer``, its ``device_memory_stats`` and
    a ``trace`` that must name the RoIAlign forward kernel. Returns the
    launches per CLI and the phase's readings."""
    import detectinblur_tpu_torch.cli.evaluate as cli_eval
    import detectinblur_tpu_torch.cli.generate_psfs as cli_gen
    import detectinblur_tpu_torch.cli.train as cli_train
    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
    from detectinblur_tpu_torch.data.blur_sampling import BlurPolicy
    from detectinblur_tpu_torch.data.coco import get_coco_kp
    from detectinblur_tpu_torch.data.loader import DetectionLoader
    from detectinblur_tpu_torch.train import eval_loop
    from detectinblur_tpu_torch.train.checkpoint import restore_weights
    from detectinblur_tpu_torch.train.engine import make_eval_step
    from detectinblur_tpu_torch.utils.profiling import (
        device_memory_stats,
        step_timer,
        trace,
    )
    from synthetic_coco import COCO_SIZES, write_coco_kp
    from torch_reference import make_random_fasterrcnn_sd

    loops, steps, launches, out = [], [], {}, {}

    def recorded_eval(*args, **kwargs):
        stats, loop = eval_loop.evaluate_coco(*args, **kwargs)
        loops.append(loop)
        return stats, loop

    make_train_step = cli_train.make_train_step

    def timed_train_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def timed(state, batch, generator=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = step(state, batch, generator=generator)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0, batch.images.shape[0]))
            return result
        return timed

    cli_train.evaluate_coco = cli_eval.evaluate_coco = recorded_eval
    cli_train.make_train_step = timed_train_step
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        per = 128
        t0 = time.perf_counter()
        gen = cli_gen.main(["--output_path", str(tmp / "psfs"),
                            "--num_psfs", str(per)])
        wall = time.perf_counter() - t0
        out["generate_psfs"] = {"psfs": gen["psfs"], "seconds": wall,
                                "psfs_per_s": gen["psfs"] / wall}
        print("cli.generate_psfs " + json.dumps(out["generate_psfs"]))
        check_psf_bank(tmp / "psfs", per)

        t0 = time.perf_counter()
        sizes = lambda n: [COCO_SIZES[i % len(COCO_SIZES)] for i in range(n)]
        root = write_coco_kp(str(tmp / "coco_kp"), {
            "train2017": sizes(8), "val2017": sizes(6)}, seed=0,
            persons=(2, 6), box_frac=(0.1, 0.6))
        pth = str(tmp / "random_2class.pth")
        torch.save({k: torch.from_numpy(v) for k, v in _scoring_pth(
            make_random_fasterrcnn_sd(np.random.default_rng(0),
                                      num_classes=2)).items()}, pth)
        print(f"phase 12 data (person-keypoint COCO, 8 + 6 images; 2-class "
              f"weights): {time.perf_counter() - t0:.2f} s")

        ckpt_dir = tmp / "out"
        fwd, bwd = {}, {}
        t0 = time.perf_counter()
        with _capture_roi_align(fwd, bwd):
            run, n = _counted(lambda: cli_train.main([
                "--data-path", root, "--dataset", "coco_kp", "--blur_train",
                "--use_stored_psfs", "--stored_psf_directory",
                str(tmp / "psfs"), "-b", "2", "--epochs", "1",
                "--early_stop", "3", "--output_dir", str(ckpt_dir),
                "--print-freq", "1", "--lr", "1e-5", "--start_from_weights",
                pth]))
        print(f"cli.train --dataset coco_kp: {time.perf_counter() - t0:.2f} "
              f"s, launches {n}, losses " + json.dumps(run.losses))
        if _missed(n) or len(run.losses) != 3 or not all(
                np.isfinite(v) for m in run.losses for v in m.values()):
            sys.exit("cli.train --dataset coco_kp: no launch, or missing or "
                     "non-finite losses")
        if run.state.model.cfg.num_classes != 2:
            sys.exit("cli.train --dataset coco_kp: not a 2-class model")
        check_captured("cli.train --dataset coco_kp", fwd, bwd)
        launches["cli_train_coco_kp"] = n
        ckpt = ckpt_dir / "model_0.pt"
        kp_args = cli_train.train_parser().parse_args(["--dataset", "coco_kp"])
        if not _same_checkpoint(ckpt, run, cli_train.build_model(kp_args,
                                                                 "cuda")):
            sys.exit("the coco_kp checkpoint did not come back bit for bit")
        warm = steps[1:]
        out["train_step_img_s"] = (sum(b for _, b in warm)
                                   / sum(s for s, _ in warm))
        out["train_step_s"] = [s for s, _ in steps]
        del run, fwd, bwd

        clean = ["--data-path", root, "--dataset", "coco_kp", "--resume",
                 str(ckpt), "--vanilla_eval"]
        images = 6
        results = {}
        for name, argv in (("clean", clean), ("image_output_dir", clean + [
                "--image_output_dir", str(tmp / "png")])):
            path = f"cli.evaluate --dataset coco_kp {name}"
            fwd = {}
            t0 = time.perf_counter()
            with _capture_roi_align(fwd, {}):
                stats, n = _counted(lambda: cli_eval.main(argv))
            print(f"{path}: {time.perf_counter() - t0:.2f} s, launches {n}, "
                  f"images {loops[-1]['images']}, detections "
                  f"{loops[-1]['detections']}")
            _check_stats(path, stats)
            if n["roi_align_fwd"] != images or loops[-1]["images"] != images:
                sys.exit(f"{path}: roi_align_fwd launched "
                         f"{n['roi_align_fwd']} times for {images} images")
            check_captured(path, fwd, {})
            launches["cli_evaluate_coco_kp_" + name] = n
            results[name] = stats, loops[-1]
            del fwd
        card, card_loop = results["clean"]
        if not card[0] > 0:
            sys.exit(f"cli.evaluate --dataset coco_kp: AP {card[0]}, no box "
                     "matched: nothing to compare")
        if not np.array_equal(card, results["image_output_dir"][0]):
            sys.exit("--image_output_dir changed the eval's stats")
        pngs = sorted((tmp / "png").iterdir())
        from PIL import Image

        distinct = [len(np.unique(np.asarray(Image.open(p)))) for p in pngs]
        print(f"--image_output_dir: {len(pngs)} PNGs, distinct values "
              f"{distinct}")
        if len(pngs) != min(50, images) or min(distinct) <= 2:
            sys.exit("--image_output_dir: missing or binarized PNGs")
        t0 = time.perf_counter()
        cpu = cli_eval.main(clean + ["--device", "cpu"])
        err = np.abs(np.asarray(card) - cpu)
        cpu_dets, card_dets = loops[-1]["detections"], card_loop["detections"]
        ok = bool(((err <= 1e-3) & (err <= 1e-3 * np.abs(cpu) + 1e-7)).all()
                  ) and abs(card_dets - cpu_dets) <= 0.02 * max(cpu_dets, 1)
        print(f"card vs CPU cli.evaluate --dataset coco_kp "
              f"({time.perf_counter() - t0:.2f} s on the CPU): max |stat "
              f"difference| {err.max():.3g}, tolerance 1e-3 and 1e-3 of each "
              f"stat; detections {card_dets} vs {cpu_dets}, tolerance 2%: "
              f"{'ok' if ok else 'FAILED'}")
        if not ok or cpu_dets == 0:
            sys.exit("the card's coco_kp eval disagrees with the CPU's")
        out["eval_img_s"] = card_loop["img_s"]
        out["eval_step_ms_per_image"] = card_loop["step_ms_per_image"]

        # The eval step under the profiling utilities, on the first val
        # image at its CLI bucket.
        model = restore_weights(str(ckpt), cli_train.build_model(kp_args,
                                                                 "cuda"))
        loader = DetectionLoader(get_coco_kp(root, "val"), 1,
                                 BlurPolicy(prob=0.0), None, shuffle=False,
                                 drop_last=False, num_workers=0)
        batch, _, _ = next(iter(loader))
        step = make_eval_step(model, model_bucket_for_batch(batch.hw))
        gen = torch.Generator(device=model.device).manual_seed(0)
        step(model, batch, gen)
        reps = 10
        with step_timer(sync=model.device) as t:
            for _ in range(reps):
                step(model, batch, gen)
        out["profiled_eval_step_ms"] = t.seconds / reps * 1e3
        out["device_memory_stats"] = device_memory_stats(model.device)
        with trace(str(tmp / "trace"), device=model.device):
            step(model, batch, gen)
            torch.cuda.synchronize()
        events = json.load(open(tmp / "trace" / "trace.json"))["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        named = sorted(k for k in kernels if "roi_align_fwd_kernel" in k)
        print(f"trace: {len(kernels)} kernel names, RoIAlign forward as "
              f"{named}")
        if not named:
            sys.exit("the profiler trace does not name the RoIAlign forward "
                     "kernel")
        del model, step
    cli_train.make_train_step = make_train_step
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    for s in loops:
        print("eval loop " + json.dumps(s))
    return launches, out


# ------------------------------------------------------ data parallel
DP_NOTE = "two ranks share one card; not a scaling number"


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _launcher_env(world=1, rank=0):
    """The environment ``torchrun`` gives a process (rank, count, local
    rank, rendezvous on this host) while open."""
    import os

    env = dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    os.environ.update(env)
    try:
        yield
    finally:
        for k in env:
            os.environ.pop(k, None)


@contextlib.contextmanager
def _recording_ddp(backends, forwards):
    """While open, the backend of each ``init_process_group`` goes into
    ``backends`` and each DDP forward adds one to ``forwards[0]``."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel as DDP

    init, forward = dist.init_process_group, DDP.forward

    def recording_init(*args, **kwargs):
        backends.append(kwargs.get("backend", args[0] if args else None))
        return init(*args, **kwargs)

    def counting_forward(self, *args, **kwargs):
        forwards[0] += 1
        return forward(self, *args, **kwargs)

    dist.init_process_group, DDP.forward = recording_init, counting_forward
    try:
        yield
    finally:
        dist.init_process_group, DDP.forward = init, forward


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def run_ddp_nccl_w1(phase8):
    """Phase 13a: phase 8's ``cli.train`` in the launcher's environment at
    world size 1: it must make an NCCL group, train through DDP (3
    forwards), launch both kernels (each held on its inputs), give phase
    8's first losses within 1e-4 relative, destroy its group and write a
    checkpoint that restores without one. Returns the launches."""
    import torch.distributed as dist

    import detectinblur_tpu_torch.cli.train as cli_train

    backends, forwards = [], [0]
    with tempfile.TemporaryDirectory() as tmp:
        root, pth = _phase8_files(tmp)
        out = str(Path(tmp) / "out")
        fwd, bwd = {}, {}
        t0 = time.perf_counter()
        with _launcher_env(), _recording_ddp(backends, forwards), \
                _capture_roi_align(fwd, bwd):
            run, launches = _counted(lambda: cli_train.main(
                _phase8_train_argv(root, out, pth)))
        first = run.losses[0]
        errs = {k: _rel(v, phase8["first_losses"][k]) for k, v in first.items()}
        print(f"NCCL W=1 cli.train: {time.perf_counter() - t0:.2f} s, "
              f"backends {backends}, DDP forwards {forwards[0]}, launches "
              f"{launches}, first losses {json.dumps(first)} against phase "
              f"8's: max relative difference {max(errs.values()):.3g}, "
              "tolerance 1e-4")
        if backends != ["nccl"] or forwards[0] != 3 or dist.is_initialized():
            sys.exit("NCCL W=1 cli.train: no NCCL group, no DDP step, or a "
                     "group left behind")
        if _missed(launches) or max(errs.values()) > 1e-4:
            sys.exit("NCCL W=1 cli.train: a kernel not launched, or losses "
                     "away from the one-process run's")
        check_captured("ddp_nccl_w1_cli_train", fwd, bwd)
        if not _same_checkpoint(Path(out) / "model_0.pt", run,
                                cli_train.build_model(
                                    cli_train.train_parser().parse_args([]),
                                    "cuda")):
            sys.exit("NCCL W=1 checkpoint: not restored bit for bit")
    return launches


def time_ddp_w1_step(gen):
    """Phase 13a: phase 5's train step (B=8, ``default``, from scratch)
    made in an NCCL group of one, so it runs in DDP (bucketing and one
    all-reduce of the gradients), against the same step made before the
    group, in turns: plain, DDP, DDP, plain. Returns (DDP img/s, plain
    img/s, the DDP step's launches)."""
    import torch.distributed as dist

    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
    )
    from detectinblur_tpu_torch.train.engine import make_train_step
    from detectinblur_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )

    bucket = model_bucket_for_batch([SRC_HW] * B)
    batch = _train_batch(gen)

    def made():
        model = FasterRCNN(FasterRCNNConfig(precision="default"),
                           device="cuda")
        opt, schedule = make_optimizer(model, base_lr=0.04,
                                       steps_per_epoch=1000)
        step = make_train_step(model, schedule, bucket, blur_train=True,
                               expand_target_boxes=True)
        return step, create_train_state(model, opt)

    plain = made()
    with _launcher_env():
        dist.init_process_group("nccl", init_method="env://", world_size=1,
                                rank=0)
        try:
            ddp = made()
            runs = {"plain": [], "ddp": []}
            states = {"plain": plain[1], "ddp": ddp[1]}
            steps = {"plain": plain[0], "ddp": ddp[0]}
            for name in ("plain", "ddp"):
                states[name], _ = steps[name](states[name], batch,
                                              generator=gen)
            _, launches = _counted(lambda: steps["ddp"](
                states["ddp"], batch, generator=gen))
            for name in ("plain", "ddp", "ddp", "plain"):
                img_s, _, states[name] = _step_img_s(steps[name],
                                                     states[name], batch, gen)
                runs[name].append(img_s)
        finally:
            dist.destroy_process_group()
    ddp_img_s, plain_img_s = (float(np.mean(runs[k])) for k in ("ddp", "plain"))
    print(f"train step B={B} in DDP (NCCL, W=1): {runs['ddp']} img/s, plain "
          f"{runs['plain']} img/s, launches {launches}")
    if _missed(launches):
        sys.exit("the DDP train step did not launch every kernel")
    return ddp_img_s, plain_img_s, launches


DP_CASES = {
    # name -> (config, step flags, batch): phase 5's step, and the remedy
    # step with train-mode BatchNorm and the deterministic remedies.
    "frozen": (dict(), dict(blur_train=True, expand_target_boxes=True)),
    "bn": (dict(bn_mode="train"),
           dict(blur_train=True, expand_target_boxes=True, use_warp=True,
                use_custom_norm=True)),
}


def _dp_model(config, device="cuda"):
    """The full-width detector from seed 0 in ``highest``, its RPN
    prediction layers zeroed, so that every anchor's objectness is its
    type's bias and proposals sit at the anchors in any batch: float noise
    between the one-process and the two-rank runs cannot change which
    rois are sampled (tests/test_torch_port_train.py's ``loss_case``)."""
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
    )

    model = FasterRCNN(FasterRCNNConfig(precision="highest", **config),
                       device=device)
    with torch.no_grad():
        for layer in (model.rpn_head.cls_logits, model.rpn_head.bbox_pred):
            layer.weight.zero_()
        model.rpn_head.bbox_pred.bias.zero_()
    return model


def _dp_step(name, rows=slice(None), inputs=None, device="cuda"):
    """One step of case ``name`` on ``inputs`` (the batch and loss draws
    on the host), rows ``rows``, on a fresh model on ``device``. Returns
    (model, metrics, a function that runs one more step)."""
    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
    from detectinblur_tpu_torch.models.faster_rcnn import LossDraws
    from detectinblur_tpu_torch.train.engine import make_train_step, to_device
    from detectinblur_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )

    config, flags = DP_CASES[name]
    batch, draws = inputs
    model = _dp_model(config, device)
    opt, schedule = make_optimizer(model, base_lr=0.02, steps_per_epoch=1)
    step = make_train_step(model, schedule,
                           model_bucket_for_batch([SRC_HW] * B), **flags)
    part = to_device(type(batch)(*(t if t is None or t.dim() == 0 else t[rows]
                                   for t in batch)), device)
    d = LossDraws(*(tuple(u[rows].to(device) for u in pair)
                    for pair in draws))
    state = [create_train_state(model, opt)]

    def again():
        state[0], metrics = step(state[0], part, draws=d)
        return metrics

    return model, {k: v.item() for k, v in again().items()}, again


def _dp_inputs(gen):
    """Phase 9's remedy batch (phase 5's, with its PSFs' blur indices for
    the norms) and per-image loss draws, on the host."""
    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch

    batch = _remedy_batch(gen)
    H, W = model_bucket_for_batch([SRC_HW] * B)
    A = 3 * sum((H // s) * (W // s) for s in (4, 8, 16, 32))
    A += 3 * ((H // 32 + 1) // 2) * ((W // 32 + 1) // 2)
    g = torch.Generator().manual_seed(13)
    u = lambda n: torch.rand(B, n, generator=g)
    draws = ((u(A), u(A)), (u(2000 + TRAIN_G), u(2000 + TRAIN_G)))
    host = type(batch)(*(None if t is None else t.cpu() for t in batch))
    return host, draws


def _dp_rank(rank, port, inputs, paths, out_dir, argv, queue):
    """One of phase 13b's two ranks, spawned: a gloo group, both ranks on
    ``cuda:0`` (an explicit ``cuda:K`` is kept under a group),
    each case's step on this rank's rows (counted, each kernel held on its
    inputs, rank 0's state saved), the step and an all-reduce of the
    gradients' size timed, then ``cli.evaluate`` at W=2 (``argv``, its
    launches counted and each kernel held). Puts (rank, ok, result)."""
    import traceback

    try:
        import torch.distributed as dist

        sys.path[:0] = paths
        import detectinblur_tpu_torch.cli.evaluate as cli_eval

        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
        try:
            got = {}
            rows = slice(rank * B // 2, (rank + 1) * B // 2)
            for name in DP_CASES:
                fwd, bwd = {}, {}
                with _capture_roi_align(fwd, bwd):
                    (model, metrics, again), launches = _counted(
                        lambda: _dp_step(name, rows, inputs, "cuda:0"))
                check_captured(f"ddp_gloo_w2 {name} rank {rank}", fwd, bwd)
                sd = {k: v.cpu() for k, v in model.state_dict().items()}
                if rank == 0:
                    torch.save(sd, Path(out_dir) / f"{name}.pt")
                no_grad = [n for n, p in model.named_parameters()
                           if p.requires_grad and p.grad is None]
                got[name] = dict(metrics=metrics, launches=launches,
                                 no_grad=no_grad, digest=_digest(sd))
                if name == "frozen":
                    got["step_ms"], got["allreduce_ms"] = _time_dp_rank(
                        model, again)
                del model, again, sd, fwd, bwd
                torch.cuda.empty_cache()
            fwd = {}
            t0 = time.perf_counter()
            with _capture_roi_align(fwd, {}):
                stats, launches = _counted(lambda: cli_eval.main(argv))
            got["eval"] = dict(stats=np.asarray(stats), launches=launches,
                               wall_s=time.perf_counter() - t0)
            check_captured(f"ddp_gloo_w2 cli.evaluate rank {rank}", fwd, {})
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, got))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))


def _digest(sd):
    import hashlib

    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def _time_dp_rank(model, again):
    """This rank's step, three more after the compared one (host clock
    around each, after a sync), and one gloo all-reduce of a float32
    tensor the size of the trainable parameters (mean of 3)."""
    import torch.distributed as dist

    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    n = sum(p.numel() for p in model.parameters() if p.requires_grad)
    flat = torch.zeros(n, device="cuda")
    dist.all_reduce(flat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        dist.all_reduce(flat)
    torch.cuda.synchronize()
    return ms, (time.perf_counter() - t0) * 1e3 / 3


def _update_errors(got, ref, p0, trainable):
    """Per trainable tensor: max |update - reference update| over the
    reference update's largest magnitude. An update that is zero in the
    reference (a bias behind the zeroed RPN layers, an FPN level no roi
    reads) must be zero."""
    errs = {}
    for k in trainable:
        d_ref = ref[k] - p0[k]
        scale = d_ref.abs().max().item()
        diff = (got[k] - p0[k] - d_ref).abs().max().item()
        errs[k] = diff / scale if scale else (float("inf") if diff else 0.0)
    return errs


def run_ddp_gloo_w2(gen, keep, phase8):
    """Phase 13b: two ranks on the one card over gloo, spawned. Each
    case's step on 4 + 4 images against this process's step on all 8:
    losses within 1e-4 relative; each parameter's update within 2e-3 of
    that tensor's largest (frozen), or within 3x the one-process step's
    own spread under a 1e-6 nudge of the images, in max and median over
    tensors (train-mode BatchNorm); the running statistics within 1e-4
    of their magnitude, the ranks' states bit-identical, every trainable
    parameter with a gradient. Then ``cli.evaluate`` at W=2 on phase 8's
    COCO and checkpoint: the merged 19 stats phase 8's exactly, one
    forward launch an image over both ranks. Returns (launches per path,
    readings)."""
    import multiprocessing

    inputs = _dp_inputs(gen)
    batch, draws = inputs
    g = torch.Generator().manual_seed(14)
    nudged = (batch._replace(images=batch.images + 1e-6 * torch.randn(
        batch.images.shape, generator=g)), draws)
    ref = {}
    for name in DP_CASES:
        p0 = {k: v.cpu() for k, v in _dp_model(DP_CASES[name][0])
              .state_dict().items()}
        runs = []
        for x in (inputs, nudged) if name == "bn" else (inputs,):
            model, metrics, _ = _dp_step(name, inputs=x)
            runs.append(({k: v.cpu() for k, v in model.state_dict().items()},
                         metrics))
            trainable = {n for n, p in model.named_parameters()
                         if p.requires_grad}
            del model
            torch.cuda.empty_cache()
        ref[name] = (p0, runs, trainable)
    here = Path(__file__).resolve().parent
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root, _ = _phase8_files(tmp)
        argv = ["--data-path", root, "--resume", str(keep / "model_0.pt"),
                "--vanilla_eval", "--device", "cuda:0"]
        procs = [ctx.Process(target=_dp_rank, args=(
            r, port, inputs, [str(here), str(here / "tests")], tmp, argv,
            queue)) for r in range(2)]
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in procs:
                rank, ok, value = queue.get(timeout=600)
                if not ok:
                    sys.exit(f"phase 13b rank {rank} failed:\n{value}")
                got[rank] = value
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
        w2 = {name: torch.load(Path(tmp) / f"{name}.pt", weights_only=True)
              for name in DP_CASES}
    seconds = time.perf_counter() - t0
    launches = {}
    for name in DP_CASES:
        p0, runs, trainable = ref[name]
        (after, metrics) = runs[0]
        r0, r1 = got[0][name], got[1][name]
        loss_err = max(_rel(r0["metrics"][k], v) for k, v in metrics.items())
        upd = _update_errors(w2[name], after, p0, trainable)
        stats = [k for k in after if k.endswith(("running_mean",
                                                 "running_var"))]
        stat_err = max(((w2[name][k] - after[k]).abs().max()
                        / after[k].abs().max()).item() for k in stats) \
            if stats else 0.0
        worst = max(upd.values())
        median = float(np.median(list(upd.values())))
        if name == "bn":
            # A from-scratch model's batch statistics make the gradients
            # chaotic: held, as phase 9 holds the card against the CPU, to
            # 3x the one-process step's own spread under a 1e-6 nudge of
            # the images.
            spread = _update_errors(runs[1][0], after, p0, trainable)
            limit = (3 * max(spread.values()),
                     3 * float(np.median(list(spread.values()))))
        else:
            limit = (2e-3, 2e-3)
        same = r0["digest"] == r1["digest"] == _digest(w2[name])
        print(f"W=2 gloo {name} step against one process on all {B}: "
              f"losses {json.dumps(r0['metrics'])} vs {json.dumps(metrics)}, "
              f"max relative {loss_err:.3g} (tolerance 1e-4); each update's "
              f"error over its tensor's largest update: max {worst:.3g}, "
              f"median {median:.3g} (tolerances {limit[0]:.3g}, "
              f"{limit[1]:.3g}; worst "
              f"{sorted(upd.items(), key=lambda kv: -kv[1])[:3]}); running "
              f"statistics {stat_err:.3g} (tolerance 1e-4); ranks identical "
              f"{same}; without a gradient {r0['no_grad'] + r1['no_grad']}")
        if (loss_err > 1e-4 or worst > limit[0] or median > limit[1]
                or stat_err > 1e-4 or not same
                or r0["metrics"] != r1["metrics"]
                or r0["no_grad"] or r1["no_grad"]):
            sys.exit(f"phase 13b: the W=2 {name} step is not the one-process "
                     "step")
        launches[f"ddp_gloo_w2_{name}_train_step"] = {
            k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}
    ev = [got[r]["eval"] for r in (0, 1)]
    n_fwd = sum(e["launches"]["roi_align_fwd"] for e in ev)
    same = all(np.array_equal(e["stats"], phase8["clean_stats"]) for e in ev)
    print(f"W=2 gloo cli.evaluate: launches {[e['launches'] for e in ev]}, "
          f"stats equal phase 8's {same}, wall {[e['wall_s'] for e in ev]} s")
    _check_stats("W=2 cli.evaluate", ev[0]["stats"])
    if not same or n_fwd != 16:
        sys.exit("phase 13b: the W=2 eval is not phase 8's one-process eval")
    launches["ddp_gloo_w2_cli_evaluate"] = {
        k: sum(e["launches"][k] for e in ev) for k in ev[0]["launches"]}
    readings = {
        "w2_gloo_step_ms": [got[r]["step_ms"] for r in (0, 1)],
        "w2_gloo_allreduce_ms": [got[r]["allreduce_ms"] for r in (0, 1)],
        "w2_eval_img_s_wall": 16 / max(e["wall_s"] for e in ev),
        "w2_note": DP_NOTE, "w2_seconds": seconds}
    return launches, readings


def run_torchrun():
    """Phase 13c: ``python -m torch.distributed.run --standalone
    --nproc_per_node 1 -m detectinblur_tpu_torch.cli.train`` on phase 8's
    COCO, one step: it must exit 0, say it made an NCCL group and write
    ``model_0.pt``. Its process group is killed on a timeout."""
    import os
    import signal

    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        root, pth = _phase8_files(tmp)
        out = Path(tmp) / "out"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m",
               "detectinblur_tpu_torch.cli.train", "--data-path", root,
               "--blur_train", "--expand_target_boxes", "-b", "2",
               "--epochs", "1", "--early_stop", "1", "--output_dir",
               str(out), "--lr", "1e-5", "--start_from_weights", pth]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            sys.exit("torchrun cli.train timed out")
        seconds = time.perf_counter() - t0
        tail = log.strip().splitlines()[-6:]
        print(f"torchrun cli.train: exit {proc.returncode} in {seconds:.2f} s; "
              + " | ".join(tail))
        if (proc.returncode != 0 or "process 0 of 1 (nccl" not in log
                or not (out / "model_0.pt").exists()):
            sys.exit("torchrun cli.train failed")
    return seconds


# ----------------------------------------------------------- NMS (phase 14)
# float32 operations of one IoU test in ops/boxes.py::box_iou's order: 2
# max, 2 min, 2 subtractions, 2 clamps, the product, the sum, the
# difference, the max with 1e-12, the division and the comparison.
NMS_OPS_PER_PAIR = 14
# Paths whose counted run must have launched the NMS kernel.
NMS_PATHS = ("serving", "train_step", "cli_evaluate",
             "single_map_mobile_net_serving", "single_map_resnet_50_serving",
             "single_map_mobile_net_train_step",
             "single_map_resnet_50_train_step")


def _hold_nms(what, fn, args):
    """``fn(*args)``, a public NMS function on card tensors, through the
    kernel under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync
    raises) and through the plain version: exit unless each greedy pass's
    alive mask and the (idxs, valid) are equal bit for bit. Returns the
    number of differing entries (0) and the kernel's greedy passes
    (boxes, alive in, threshold, alive out)."""
    from detectinblur_tpu_torch.ops import nms

    got_rec, ref_rec = [], []
    before = nms.nms_alive.launches
    with _nms_route(False, got_rec):
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    launched = nms.nms_alive.launches - before
    with _nms_route(True, ref_rec):
        ref = fn(*args)
    masks = [(g[3], r[3]) for g, r in zip(got_rec, ref_rec)]
    diff = sum(int((g != r).sum()) for g, r in masks)
    same_out = all(torch.equal(g, r) for g, r in zip(got, ref))
    held = [_hold_mask(rec) for rec in got_rec]
    covered, words_diff, scan_diff = (sum(h[i] for h in held)
                                      for i in range(3))
    ok = (launched == len(got_rec) == len(ref_rec) == 1 and diff == 0
          and same_out and words_diff == 0 and scan_diff == 0)
    print(f"{what}: alive {[tuple(g.shape) for g, _ in masks]}, kept "
          f"{sum(int(g.sum()) for g, _ in masks)}, {diff} entries differ, "
          f"(idxs, valid) {'equal' if same_out else 'DIFFER'}, {launched} "
          f"launch, no host sync; mask kernel alone on a scratch of ones: "
          f"{words_diff} of {covered} covered words differ, the scan on it: "
          f"{scan_diff} alive entries differ: {'ok' if ok else 'FAILED'}")
    if not ok:
        sys.exit(f"{what}: the NMS kernel disagrees with its plain version")
    return diff, got_rec


def _hold_mask(rec):
    """``nms_mask`` (the mask kernel alone) on one greedy pass's inputs,
    its scratch first filled with ones, held word for word against
    ``_suppression_mask_plain`` on the words it must write
    (``_covered_words``: the alive rows', from each row's own word on);
    then ``nms_scan`` on that scratch, whose unwritten words still hold
    ones, held against the pass's alive mask. Returns (covered words,
    differing words, differing alive entries); a failed launch counts
    every word or entry it should have given as differing."""
    from detectinblur_tpu_torch.ops import nms

    sboxes, salive, thr, want = rec
    b, a = sboxes.float().contiguous(), salive.contiguous()
    alive, mask, args = nms.kernel_args(b, a, thr)
    mask.fill_(-1)
    covered = nms._covered_words(a)
    n = int(covered.sum())
    err = nms._library().nms_mask(*args)
    if err:
        print(f"nms_mask launch failed: CUDA error {err}")
        return n, max(n, 1), 0
    got = torch.where(covered, mask, 0)
    words = int((got != nms._suppression_mask_plain(b, a, thr)).sum())
    err = nms._library().nms_scan(*args)
    if err:
        print(f"nms_scan launch failed: CUDA error {err}")
        return n, words, max(int(a.numel()), 1)
    return n, words, int((alive != want).sum())


def nms_bound(sboxes, salive, alive):
    """(bound ms, bound_by, bytes, ops, pairs, the bound over all pairs)
    of the greedy pass on these inputs: the IoU tests this run's answer
    needs, one per pair (kept r, alive c > r), at ``NMS_OPS_PER_PAIR``
    float32 operations, plus 3 a box for its area; the boxes read once,
    the alive mask read and written once. Beside it, the bound of the
    N(N-1)/2 pairs of each problem."""
    M, N = salive.shape
    later = salive.flip(1).int().cumsum(1).flip(1) - salive.int()
    pairs = int((alive.int() * later).sum())
    nbytes = M * N * (16 + 1 + 1)
    ops = NMS_OPS_PER_PAIR * pairs + 3 * M * N
    all_ops = NMS_OPS_PER_PAIR * (M * N * (N - 1) // 2) + 3 * M * N
    return (*_bound(nbytes, ops), nbytes, ops, pairs,
            _bound(nbytes, all_ops)[0])


def nms_mask_bound(sboxes, salive):
    """(bound ms, bound_by, bytes, ops, pairs) of the mask kernel alone on
    these inputs: the pairs it needs, alive r < alive c of one problem, at
    ``NMS_OPS_PER_PAIR`` float32 operations, plus 3 an alive box for its
    area; the alive boxes and the whole alive mask read once, and the
    words it must write (from each alive row's own word on) written
    once."""
    M, N = salive.shape
    a = salive.long()
    later = a.flip(1).cumsum(1).flip(1) - a
    pairs = int((a * later).sum())
    own_on = -(-N // 64) - torch.arange(N, device=a.device) // 64
    nbytes = 16 * int(a.sum()) + M * N + 8 * int((a * own_on).sum())
    ops = NMS_OPS_PER_PAIR * pairs + 3 * int(a.sum())
    return (*_bound(nbytes, ops), nbytes, ops, pairs)


def _graph_ms(make, n=20, reps=10):
    """Device ms of one call of the launch that ``make()`` returns (a
    callable of no arguments that launches on the stream current when
    ``make`` ran): ``n`` calls captured in a CUDA graph, replayed ``reps``
    times between CUDA events. A kernel of a few microseconds launched
    back to back from Python runs at the host's launch rate; replayed
    from a graph it does not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        launch = make()
        if launch():
            sys.exit("_graph_ms: the launch failed")
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="relaxed"):
            for _ in range(n):
                launch()
    torch.cuda.current_stream().wait_stream(side)
    return _cuda_ms(graph.replay, reps) / n


def time_nms(rec, where):
    """nms_alive alone on one greedy pass's inputs (CUDA events over
    calls of the wrapper), and each of its two kernels alone, replayed
    from a CUDA graph (``nms_mask_kernel``, then ``nms_scan_kernel`` on
    the mask it wrote: the scan's ms over its ceil(N/64) dependent steps
    is the cost of a step), beside the plain version on the card and the
    bound."""
    from detectinblur_tpu_torch.ops import nms

    sboxes, salive, thr, alive = rec
    b, a = sboxes.float().contiguous(), salive.contiguous()
    ms = _cuda_ms(lambda: nms.nms_alive(b, a, thr), 20)
    lib = nms._library()

    def launcher(name):
        def make():
            out = nms.kernel_args(b, a, thr)   # kept alive by the closure
            if name == "nms_scan" and lib.nms_mask(*out[2]):
                sys.exit("time_nms: nms_mask failed")
            fn = getattr(lib, name)
            return lambda: fn(*out[2])
        return make

    mask_ms = _graph_ms(launcher("nms_mask"))
    scan_ms = _graph_ms(launcher("nms_scan"))
    plain_ms = _cuda_ms(lambda: nms._alive_sorted_plain(b, a, thr), 3)
    bound_ms, bound_by, nbytes, ops, pairs, all_ms = nms_bound(b, a, alive)
    (mask_bound_ms, mask_bound_by, mask_bytes, mask_ops,
     alive_pairs) = nms_mask_bound(b, a)
    M, N = a.shape
    steps = -(-N // 64)
    out = {"shape": [M, N], "ms": ms, "mask_ms": mask_ms, "scan_ms": scan_ms,
           "scan_us_per_step": scan_ms * 1e3 / steps, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "all_pairs_bound_ms": all_ms, "mask_bound_ms": mask_bound_ms,
           "mask_bound_by": mask_bound_by,
           "mask_share": mask_bound_ms / mask_ms, "alive_pairs": alive_pairs,
           "scan_steps": steps, "alive_in": int(a.sum()),
           "kept": int(alive.sum())}
    print(f"nms_alive on {where} ({M} x {N}, thr {thr}): {ms:.4f} ms (in "
          f"a CUDA graph: mask kernel {mask_ms:.4f} ms, scan kernel "
          f"{scan_ms:.4f} ms = "
          f"{out['scan_us_per_step']:.3f} us a step over {steps} dependent "
          f"64-box steps), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"by {bound_by} ({pairs} pairs (kept, later alive), {ops} "
          f"operations, {nbytes} bytes; all N(N-1)/2 pairs {all_ms:.5f} "
          f"ms), {out['alive_in']} alive in, {out['kept']} kept; mask "
          f"kernel's own bound {mask_bound_ms:.5f} ms by {mask_bound_by} "
          f"({alive_pairs} alive pairs, {mask_ops} operations, {mask_bytes} "
          f"bytes), {out['mask_share']:.1%} of it")
    return out


def run_nms_phase(by_path):
    """Phase 14: the NMS kernel held bit for bit against its plain version
    (``_hold_nms``) on the hard cases of ``tests/nms_cases.py`` and on what
    the RPN and the postprocess handed the NMS functions in phases 4, 5, 8
    and 11 (``NMS_CAPTURED``), then timed on each of those inputs. Returns
    the kernel's entry of the ``kernels`` line."""
    import nms_cases

    from detectinblur_tpu_torch.ops import nms

    missing = [p for p in NMS_PATHS if not by_path["nms_alive"].get(p)]
    if missing:
        sys.exit(f"phase 14: no nms_alive launch on the paths {missing}")
    diffs = 0
    small = []
    timings = {}
    # The hard cases, and the card-only one whose row blocks the scan
    # streams in column tiles (timed too).
    streamed = nms_cases.streamed_case()
    for case in nms_cases.cases() + [streamed]:
        n = len(case["scores"])
        boxes = torch.from_numpy(case["boxes"]).cuda()
        scores = torch.from_numpy(case["scores"]).cuda()
        cats = case["categories"]
        cats = torch.from_numpy(np.ones(n, np.int32) if cats is None
                                else cats).cuda()
        for name, args in (("nms", (boxes, scores, case["thr"], n + 3)),
                           ("batched_nms", (boxes, scores, cats, case["thr"],
                                            min(n, 100)))):
            d, recs = _hold_nms(f"phase 14 {case['name']}: {name}",
                                getattr(nms, name), args)
            diffs += d
            if case is streamed and name == "nms":
                where = f"card-only case: nms [{n}]"
                timings[where] = time_nms(recs[0], where)
        if case["expect"] is not None:
            idxs, valid = nms.nms(boxes, scores, case["thr"], n + 3)
            kept = idxs[valid].tolist()
            if kept != case["expect"]:
                sys.exit(f"phase 14 {case['name']}: kept {kept}, want "
                         f"{case['expect']}")
        if n <= 200 and case["thr"] == 0.5:
            small.append(nms_cases.sorted_problem(case))
    # The small cases at threshold 0.5 as the groups of one call, padded
    # with dead entries to one length.
    K = max(len(b) for b, _ in small)
    gb = torch.zeros(len(small), K, 4)
    gs = torch.full((len(small), K), float(nms_cases.NEG_INF))
    for g, (b, a) in enumerate(small):
        gb[g, :len(b)] = torch.from_numpy(b)
        gs[g, :len(b)] = torch.where(torch.from_numpy(a),
                                     torch.linspace(1, 0.01, len(b)),
                                     float(nms_cases.NEG_INF))
    d, _ = _hold_nms(f"phase 14 {len(small)} groups of {K}: "
                     "grouped_nms_presorted", nms.grouped_nms_presorted,
                     (gb.cuda(), gs.cuda(), 0.5, len(small) * K))
    diffs += d

    for (path, name, shapes), (_, args) in NMS_CAPTURED.items():
        where = f"{path}: {name} {list(shapes[0])}"
        d, recs = _hold_nms(f"phase 14 {where}", getattr(nms, name), args)
        diffs += d
        timings[where] = time_nms(recs[0], where)
    serving = next(v for k, v in timings.items() if k.startswith("serving"))
    return {
        "name": "nms_alive",
        "route": "cuda",
        "source": "detectinblur_tpu_torch/csrc/nms.cu",
        "replaces": "detectinblur_tpu/ops/nms.py:66",
        "launches": None,
        "max_abs_err": float(diffs),
        "ms": serving["ms"],
        "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": None,
        "paths": timings,
    }


# ------------------------------------------------- entry points (phase 15)
# Each benchmark module: (its JAX twin's metric, the keys of the JAX
# line, bench.py:159-166, bench_train.py:131-136, bench_pipeline.py:
# 281-294, the keys that must be finite and > 0).
BENCH_LINES = {
    "serve": ("blur_detect_images_per_sec_per_chip",
              {"metric", "value", "unit", "vs_baseline", "window_rates",
               "best_window"}, ("value", "vs_baseline", "best_window")),
    "train": ("train_step_images_per_sec_per_chip",
              {"metric", "value", "unit", "step_ms"}, ("value", "step_ms")),
    "pipeline": ("pipeline_train_images_per_sec_per_chip",
                 {"metric", "value", "unit", "step_ms", "h2d_ms",
                  "loader_wait_ms", "loader_only_img_s", "workers",
                  "host_cores", "flops_per_step", "device_kind", "mfu"},
                 ("value", "step_ms", "h2d_ms", "loader_only_img_s",
                  "flops_per_step", "mfu")),
}


def run_bench_module(name):
    """``python -m detectinblur_tpu_torch.bench.<name>`` with the
    checkout on ``PYTHONPATH`` and the default protocol, as a user runs
    it: exit unless it ends 0 with one JSON line, the last of stdout,
    with its JAX twin's keys and finite positive numbers. Returns the
    line's record."""
    import math
    import os
    import signal

    here = Path(__file__).resolve().parent
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=str(here) + (os.pathsep + path
                                                   if path else ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"detectinblur_tpu_torch.bench.{name}"],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        sys.exit(f"bench.{name} timed out")
    seconds = time.perf_counter() - t0
    for line in err.strip().splitlines()[-12:]:
        print(f"  bench.{name} stderr: {line}")
    lines = out.strip().splitlines()
    print(f"bench.{name}: exit {proc.returncode} in {seconds:.1f} s; "
          f"{lines[-1] if lines else '(no output)'}")
    if proc.returncode != 0 or not lines:
        sys.exit(f"bench.{name} failed")
    record = json.loads(lines[-1])
    metric, keys, positive = BENCH_LINES[name]
    ok = (set(record) == keys and record["metric"] == metric
          and sum(line.lstrip().startswith("{") for line in lines) == 1
          and all(isinstance(record[k], (int, float))
                  and math.isfinite(record[k]) and record[k] > 0
                  for k in positive))
    if name == "pipeline":
        ok = ok and record["device_kind"] == torch.cuda.get_device_name(0)
    if not ok:
        sys.exit(f"bench.{name}: its last line is not its JAX twin's")
    return record | {"seconds": seconds}


def pipeline_epochs():
    """Phase 15: ``bench.pipeline``'s epoch (256 JPEGs, 8 threads, B=8) in
    turns with the loader live (its threads beside the step, as the
    benchmark runs it) and with the epoch's batches taken first (no
    loader thread running): img/s and, a step, ms on the wall clock, ms
    in the step's calls on the host and ms waiting on the loader."""
    from detectinblur_tpu_torch.bench import pipeline
    from detectinblur_tpu_torch.bench.common import default_config
    from detectinblur_tpu_torch.bench.train import make_step

    dev = torch.device("cuda")
    turns = {"live": [], "taken": []}
    with tempfile.TemporaryDirectory() as root:
        loader = pipeline.make_loader(root, 256, 8, device=dev)
        _, state, step = make_step(default_config(), B, SRC_HW, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        loader.set_epoch(1)
        taken = list(loader)
        state = pipeline.run_epoch(taken[:3], step, state, gen, dev).state
        for name in ("live", "taken", "taken", "live"):
            e = pipeline.run_epoch(loader if name == "live" else taken, step,
                                   state, gen, dev)
            state = e.state
            turns[name].append({
                "img_s": e.steps * B / e.wall, "ms": e.wall / e.steps * 1e3,
                "host_ms": e.host / e.steps * 1e3,
                "wait_ms": e.wait / e.steps * 1e3})
    print("bench.pipeline's epoch, loader live vs batches taken first, in "
          "turns: " + json.dumps(turns))
    return turns


def run_bench_phase():
    """Phase 15: the three benchmark modules as a user runs them, then
    ``bench.pipeline``'s epoch with the loader live and with its batches
    taken first (``pipeline_epochs``), then ``serve.run`` and
    ``train.run`` in this process at one short window under the launch
    counters, each kernel held against its plain version on the inputs
    they handed it. Returns (launches per kernel on each path, the three
    records and the epochs)."""
    from detectinblur_tpu_torch.bench import serve, train
    from detectinblur_tpu_torch.ops import nms

    records = {name: run_bench_module(name) for name in BENCH_LINES}
    records["pipeline_epochs"] = pipeline_epochs()
    launches = {}
    # Serving: 2 warm-up calls (eager, capture) and 2 replayed timed
    # calls; the train step: a warm-up and 2 timed steps, no predict.
    for path, run, kernels, forwards, graphed_want in (
            ("bench_serve", lambda: serve.run(iters=2, repeats=1),
             ("roi_align_fwd", "nms_alive"), 4,
             {"first": 1, "capture": 1, "replay": 2}),
            ("bench_train", lambda: train.run(iters=2, repeats=1),
             ("roi_align_fwd", "roi_align_bwd", "nms_alive"), 3, {})):
        fwd, bwd = {}, {}
        with _capture_roi_align(fwd, bwd), _capture_nms(path):
            (record, launches[path]), graphed = _graphed(
                lambda: _counted(run))
        print(f"{path} in this process: launches {launches[path]}, "
              f"predict graphs {graphed}, " + json.dumps(record))
        if any(launches[path][k] == 0 for k in kernels):
            sys.exit(f"{path} did not launch each of {kernels}")
        if graphed != graphed_want:
            sys.exit(f"{path} ran predict {graphed}, want {graphed_want}")
        _check_passes(path, launches[path], forwards)
        check_captured(path, fwd, bwd)
        for (p, name, shapes), (_, args) in list(NMS_CAPTURED.items()):
            if p == path:
                _hold_nms(f"{path}: {name} {list(shapes[0])}",
                          getattr(nms, name), args)
    return launches, records


# ------------------------------------------------- conv epilogue (phase 16)
def _epilogue_passes():
    """(shape, residual) of each conv-epilogue pass, in call order, of one
    ``default``-precision ResNet50-FPN backbone forward at bench.py's batch
    (8 frames in the 832x1088 bucket), recorded from the kernel's
    wrapper."""
    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
    from detectinblur_tpu_torch.models.resnet import ResNetFPN
    from detectinblur_tpu_torch.ops import conv_epilogue as ce

    H, W = model_bucket_for_batch([SRC_HW] * B)
    net = ResNetFPN(act_dtype=torch.bfloat16)
    net.reset_parameters(torch.Generator().manual_seed(0))
    net.cuda()
    images = torch.rand(B, H, W, 3, device="cuda")
    passes, kernel = [], ce.conv_epilogue_kernel

    def record(y, shift, residual=None):
        passes.append((tuple(y.shape), residual is not None))
        return kernel(y, shift, residual)

    record.launches = kernel.launches     # the kernel counts on its name
    ce.conv_epilogue_kernel = record
    try:
        with torch.no_grad():
            net(images)
    finally:
        ce.conv_epilogue_kernel = kernel
        kernel.launches = record.launches
    torch.cuda.synchronize()
    return passes


def _unfolded_pass(y, scale, bias, residual):
    """The same pass unfolded: FrozenBatchNorm's mul and add (with their
    casts), then the residual add and the ReLU."""
    out = y * scale.to(y.dtype)[:, None, None] + bias.to(y.dtype)[:, None, None]
    if residual is not None:
        out = out + residual
    return torch.relu(out)


def run_epilogue_phase():
    """Phase 16: the conv-epilogue kernel (``csrc/conv_epilogue.cu``)
    held bit for bit against its plain version and timed, in bfloat16
    and float32, on each distinct pass of a ResNet50-FPN forward at
    bench.py's shapes: replayed from a CUDA graph (``ms``), and launched
    back to back through its Python wrapper (``wrapper_ms``, which the
    host's rate sets on the small passes); beside it its bound (y and
    the residual read once, out written once, at 3.35 TB/s), the plain
    version and the unfolded ops it replaced. Returns the kernel's entry
    of the ``kernels`` line."""
    from detectinblur_tpu_torch.ops import conv_epilogue as ce

    passes = _epilogue_passes()
    if len(passes) != PASSES:
        sys.exit(f"phase 16: {len(passes)} passes a forward, want {PASSES}")
    counts = {}
    for p in passes:
        counts[p] = counts.get(p, 0) + 1
    print(f"phase 16: {len(passes)} passes a forward, {len(counts)} shapes")
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows, totals = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        tot = dict.fromkeys(("ms", "wrapper_ms", "bound_ms", "plain_ms",
                             "unfolded_ms"), 0.0)
        for (shape, residual), n in counts.items():
            def draw():
                return torch.randn(shape, generator=gen, device="cuda").to(
                    dtype).contiguous(memory_format=torch.channels_last)
            y, res = draw(), draw() if residual else None
            shift = torch.randn(shape[1], generator=gen, device="cuda")
            scale = torch.rand(shape[1], generator=gen, device="cuda") + 0.5
            got = ce.conv_epilogue_kernel(y, shift, res)
            ref = ce.conv_epilogue_plain(y, shift, res)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                sys.exit(f"phase 16 {_name(dtype)} {list(shape)} residual "
                         f"{residual}: the kernel disagrees with its plain "
                         f"version")
            del got, ref
            nbytes = y.numel() * y.element_size() * (3 if residual else 2)
            out = torch.empty_like(y)

            def make():
                stream = torch.cuda.current_stream().cuda_stream
                args = (ce._DTYPES[dtype], y.data_ptr(), shift.data_ptr(),
                        None if res is None else res.data_ptr(),
                        out.data_ptr(), y.numel(), shape[1], stream)
                return lambda: ce._kernel()(*args)

            row = {
                "dtype": _name(dtype), "shape": list(shape),
                "residual": residual, "passes": n,
                "ms": _graph_ms(make),
                "wrapper_ms": _cuda_ms(lambda: ce.conv_epilogue_kernel(
                    y, shift, res), 20),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "plain_ms": _cuda_ms(
                    lambda: ce.conv_epilogue_plain(y, shift, res), 5),
                "unfolded_ms": _cuda_ms(
                    lambda: _unfolded_pass(y, scale, shift, res), 5),
            }
            row["share"] = row["bound_ms"] / row["ms"]
            print(f"phase 16 {json.dumps(row)}")
            rows.append(row)
            for k in tot:
                tot[k] += n * row[k]
            del y, res, out
        tot["share"] = tot["bound_ms"] / tot["ms"]
        totals[_name(dtype)] = tot
        print(f"phase 16 a forward's passes, {_name(dtype)}: "
              + json.dumps(tot))
    torch.cuda.empty_cache()
    bf16 = totals[_name(torch.bfloat16)]
    return {
        "name": "conv_epilogue",
        "route": "cuda",
        "source": "detectinblur_tpu_torch/csrc/conv_epilogue.cu",
        "replaces": None,
        "launches": None,
        "max_abs_err": 0.0,
        "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "unfolded_ms": bf16["unfolded_ms"],
        "paths": rows,
    }


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    # The port and its kernel sources must come from this checkout.
    here = Path(__file__).resolve().parent
    if not (here / "detectinblur_tpu_torch" / "csrc").is_dir():
        sys.exit(f"chip_smoke: no detectinblur_tpu_torch/ beside {here}; "
                 "run it from a checkout of the repo")
    sys.path.insert(0, str(here))
    # The test helpers that make phase 8's data and weights (numpy and
    # torch only), imported by name as the tests import them.
    sys.path.insert(1, str(here / "tests"))
    from detectinblur_tpu_torch.utils import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = cuda_build.build(["roi_align_fwd", "roi_align_bwd", "nms",
                             "conv_epilogue"])
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
    serving_passes, launches, nms_launches, feats, rois, serving_img_s = (
        run_slice(cuda_gen))
    kernels = time_kernels(feats, rois, launches, errs)
    del feats, rois
    train_launches, levels, captured, train_img_s = run_train(cuda_gen)
    time_fwd_kernel(levels, captured[1], captured[2], "the train step's rois")
    kernels.append(time_bwd_kernel(captured,
                                   train_launches["roi_align_bwd"], bwd_errs))
    del levels, captured
    check_against_cpu()
    check_train_against_cpu()
    keep = tempfile.TemporaryDirectory()
    entry, phase8 = run_entry_points(Path(keep.name))
    remedy_train, remedy_img_s = run_remedy_train(cuda_gen)
    remedy_predict, remedy_predict_img_s = run_remedy_predict(cuda_gen)
    check_remedies_against_cpu()
    entry.update(run_remedy_entry_points())
    print("remedies " + json.dumps({
        "train_img_s": remedy_img_s, "plain_train_img_s": train_img_s,
        "predict_img_s": remedy_predict_img_s, "serving_img_s": serving_img_s}))
    t0 = time.perf_counter()
    deblur = run_deblur(gen)
    estimator = run_estimator(gen)
    ensemble_launches, ensemble_loops = run_ensemble_entry_points(
        Path(keep.name))
    entry.update(ensemble_launches)
    print("phase 10 " + json.dumps({
        "deblur": deblur, "estimator_train": estimator,
        "ensemble_eval_loops": ensemble_loops,
        "seconds": time.perf_counter() - t0}))

    t0 = time.perf_counter()
    single = {}
    for flag, torso in SINGLE_MAP:
        serve_n, fwd_t, serve = run_single_map_serving(torso, cuda_gen)
        train_n, bwd_t, train = run_single_map_train(torso, cuda_gen)
        single[flag] = (serve_n, train_n, fwd_t, bwd_t, serve, train)
        torch.cuda.empty_cache()
    check_single_map_against_cpu()
    entry.update(run_single_map_entry_points())
    print("phase 11 " + json.dumps({
        flag: {"serving_img_s": v[4]["img_s"], "train_img_s": v[5]["img_s"],
               "train_peak_mem_gib": v[5]["peak_mem_gib"],
               "fwd_ms": v[2][0], "fwd_bound_ms": v[2][2],
               "bwd_ms": v[3]["ms"], "bwd_bound_ms": v[3]["bound_ms"]}
        for flag, v in single.items()} | {
            "seconds": time.perf_counter() - t0}))

    t0 = time.perf_counter()
    kp_launches, kp = run_keypoint_entry_points()
    entry.update(kp_launches)
    print("phase 12 " + json.dumps(kp | {"seconds": time.perf_counter() - t0}))

    t0 = time.perf_counter()
    entry["ddp_nccl_w1_cli_train"] = run_ddp_nccl_w1(phase8)
    ddp_img_s, plain_img_s, entry["ddp_nccl_w1_train_step"] = (
        time_ddp_w1_step(cuda_gen))
    dp_launches, dp = run_ddp_gloo_w2(cuda_gen, Path(keep.name), phase8)
    entry.update(dp_launches)
    keep.cleanup()
    torchrun_s = run_torchrun()
    print("phase 13 " + json.dumps({
        "ddp_w1_train_img_s": ddp_img_s, "plain_train_img_s": plain_img_s,
        **dp, "torchrun_cli_train_s": torchrun_s,
        "seconds": time.perf_counter() - t0}))

    by_path = {
        "roi_align_fwd": {"serving": launches,
                          "train_step": train_launches["roi_align_fwd"],
                          "remedy_train_step": remedy_train["roi_align_fwd"],
                          "remedy_predict": remedy_predict["roi_align_fwd"]},
        "roi_align_bwd": {"train_step": train_launches["roi_align_bwd"],
                          "remedy_train_step": remedy_train["roi_align_bwd"]},
        "nms_alive": {"serving": nms_launches,
                      "train_step": train_launches["nms_alive"],
                      "remedy_train_step": remedy_train["nms_alive"],
                      "remedy_predict": remedy_predict["nms_alive"]},
        EPILOGUE: {"serving": serving_passes,
                   "train_step": train_launches[EPILOGUE]},
    }
    for flag, (serve_n, train_n, _, _, _, _) in single.items():
        for path, counts in ((f"single_map_{flag}_serving", serve_n),
                             (f"single_map_{flag}_train_step", train_n)):
            for name, n in counts.items():
                if n:
                    by_path[name][path] = n
    for path, counts in entry.items():
        for name, n in counts.items():
            if n:
                by_path[name][path] = n
    # The single-map paths' own readings of each kernel (phase 11).
    kernels[0]["single_map"] = {
        flag: dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), v[2]))
        for flag, v in single.items()}
    kernels[1]["single_map"] = {
        flag: {k: v[3][k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "max_abs_err")}
        for flag, v in single.items()}
    t0 = time.perf_counter()
    kernels.append(run_nms_phase(by_path))
    print(f"phase 14 {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    bench_launches, bench = run_bench_phase()
    for path, counts in bench_launches.items():
        for name, n in counts.items():
            if n:
                by_path[name][path] = n
    print("phase 15 " + json.dumps(bench | {
        "seconds": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    kernels.append(run_epilogue_phase())
    print(f"phase 16 {time.perf_counter() - t0:.2f} s")
    for k in kernels:
        k["launches_by_path"] = by_path[k["name"]]
        k["launches"] = sum(by_path[k["name"]].values())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
