"""Drive the PyTorch port of the serving path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. Require CUDA; print the card's name and power limit.
  2. Build every kernel of the path from the sources in the checkout.
  3. Hold each kernel against its plain torch version at the serving
     shapes (8 images x 1000 rois on the 832x1088 bucket's P2..P5),
     float32 and bfloat16, on rois that include anchors, slivers, boxes
     past the image edge, giants clamped to P5 and zeroed invalid slots.
  4. Run the slice with bench.py's protocol: 8 random 480x640 images,
     camera-shake PSFs (expl 0.005, fraction 0.5) sampled once, blur, then
     Faster R-CNN ResNet50-FPN predict at full width in throughput
     (``default``) precision with the RPN delta head zeroed. Check the
     outputs, prove the main path launched every kernel, time it (img/s
     and ms per stage with CUDA events).
  5. Time each kernel on the main path's own inputs beside its plain
     version and its bound.
  6. Hold the card's predict (``highest`` precision, kernel) against the
     port's CPU predict (plain version) on a small input.

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
    Bn = N // R
    device = g.level.device
    lvl = g.level.long()
    sizes = torch.tensor([[f.shape[1], f.shape[2]] for f in feats],
                         device=device)
    cells = sizes[:, 0] * sizes[:, 1]
    base = torch.cumsum(Bn * cells, 0) - Bn * cells
    img = torch.arange(N, device=device) // R
    row0 = base[lvl] + img * cells[lvl]
    W = sizes[lvl, 1]
    idx = (row0[:, None, None, None, None]
           + g.y_idx.long()[:, :, None, :, None] * W[:, None, None, None, None]
           + g.x_idx.long()[:, None, :, None, :])
    need = (g.y_w[:, :, None, :, None] * g.x_w[:, None, :, None, :]) != 0
    unique_cells = torch.unique(idx[need]).numel()
    elem = feats[0].element_size()
    out_bytes = N * 49 * C * elem
    geom_bytes = sum(t.numel() * t.element_size() for t in g)
    nbytes = out_bytes + unique_cells * C * elem + geom_bytes
    ops = N * 49 * C * 16 * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops, unique_cells)


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


def time_kernels(feats, rois, launches, errs):
    """The kernel alone (from the shared geometry table) vs the plain
    version from the same table, on the main path's features and rois."""
    from detectinblur_tpu_torch.ops.roi_align import (
        roi_align_from_geometry,
        roi_geometry,
    )
    from detectinblur_tpu_torch.ops.roi_align_cuda import roi_align_fwd

    R = rois.shape[1]
    shapes = [f.shape[1:3] for f in feats]
    f32 = [f.float() for f in feats]
    with torch.inference_mode():
        geom_ms = _cuda_ms(lambda: roi_geometry(rois.reshape(-1, 4), shapes), 20)
        geom = roi_geometry(rois.reshape(-1, 4), shapes)
        ms = _cuda_ms(lambda: roi_align_fwd(feats, geom, R), 20)
        plain_ms = _cuda_ms(lambda: roi_align_from_geometry(feats, geom, R), 3)
        ms32 = _cuda_ms(lambda: roi_align_fwd(f32, geom, R), 20)
        plain32 = _cuda_ms(lambda: roi_align_from_geometry(f32, geom, R), 3)
    bound_ms, bound_by, nbytes, ops, cells = roi_align_bound(feats, geom, R)
    bound32, _, bytes32, _, _ = roi_align_bound(f32, geom, R)
    print(f"roi_align geometry (torch, shared by both versions): "
          f"{geom_ms:.4f} ms")
    print(f"roi_align_fwd bfloat16 on the main path's rois: {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes"
          f", {cells} unique feature cells, {ops} operations)")
    print(f"roi_align_fwd float32 on the main path's rois: {ms32:.4f} ms, "
          f"plain {plain32:.4f} ms, bound {bound32:.4f} ms "
          f"({bytes32} bytes)")
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
    logs = cuda_build.build(["roi_align_fwd"])
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    from detectinblur_tpu_torch.data.batching import model_bucket_for_batch

    errs = check_kernels(model_bucket_for_batch([SRC_HW] * B), gen)
    cuda_gen = torch.Generator(device="cuda").manual_seed(1)
    _, launches, feats, rois = run_slice(cuda_gen)
    kernels = time_kernels(feats, rois, launches, errs)
    check_against_cpu()

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
