"""COCO evaluation loop (host orchestration around the eval step).

Port of ``detectinblur_tpu/train/eval_loop.py``: the batch-1 protocol of
the reference's engine.evaluate (engine.py:220-416), device-side blur and
box expansion in the step, the optional expanded-GT rewrite of the GT
annotations (positional against img_to_anns, as the reference does),
detections collected as COCO results, merged across processes, then
accumulate and the 19-stat summary; with ``image_output_dir``, the first
50 iterations' first image with its boxes drawn.

The cross-process merge gathers each process's payload with
``torch.distributed.all_gather_object`` and keeps each image's payloads
from the first process that evaluated it.
"""

from __future__ import annotations

import copy
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from detectinblur_tpu_torch.eval.coco_eval import COCOEval, STAT_NAMES
from detectinblur_tpu_torch.eval.coco_index import COCOIndex
from detectinblur_tpu_torch.parallel.dist import process_count, process_index
from detectinblur_tpu_torch.utils.metric_logger import MetricLogger
from detectinblur_tpu_torch.utils.visualization import dump_detections


def dataset_to_coco_index(dataset) -> COCOIndex:
    """A GT index built from the dataset's items, for datasets without a
    native COCO index (convert_to_coco_api, coco_utils.py:147-211)."""
    images, annotations, cats = [], [], set()
    aid = 1
    for i in range(len(dataset)):
        item = dataset[i]
        h, w = item["image"].shape[:2]
        images.append({"id": item["image_id"], "height": h, "width": w})
        for b, lab, area, crowd in zip(item["boxes"], item["labels"],
                                       item["area"], item["iscrowd"]):
            annotations.append({
                "id": aid,
                "image_id": item["image_id"],
                "category_id": int(lab),
                "bbox": [float(b[0]), float(b[1]),
                         float(b[2] - b[0]), float(b[3] - b[1])],
                "area": float(area),
                "iscrowd": int(crowd),
            })
            cats.add(int(lab))
            aid += 1
    return COCOIndex({
        "images": images,
        "annotations": annotations,
        "categories": [{"id": c} for c in sorted(cats)],
    })


def rewrite_expanded_gt(coco_gt: COCOIndex, image_id: int,
                        expanded_xyxy: np.ndarray, n_valid: int) -> int:
    """Positional bbox rewrite (engine.py:325-342). Returns how many of
    the image's annotations had no expanded box."""
    anns = coco_gt.img_to_anns[image_id]
    faulty = 0
    for k, ann in enumerate(anns):
        if k >= n_valid:
            faulty += 1
            continue
        b = expanded_xyxy[k]
        ann["bbox"] = [float(b[0]), float(b[1]),
                       float(b[2] - b[0]), float(b[3] - b[1])]
    return faulty


def collect_detections(dets, image_ids, results: List[dict]):
    """Append COCO result dicts from a Detections batch (xyxy -> xywh)."""
    boxes, scores, labels, valid = (t.cpu().numpy() for t in dets)
    for i, img_id in enumerate(image_ids):
        for b, s, l, v in zip(boxes[i], scores[i], labels[i], valid[i]):
            if not v:
                continue
            results.append({
                "image_id": int(img_id),
                "category_id": int(l),
                "bbox": [float(b[0]), float(b[1]),
                         float(b[2] - b[0]), float(b[3] - b[1])],
                "score": float(s),
            })


def merge_host_payloads(
    per_host_ids: List[List[int]],
    per_host_results: List[List[dict]],
    per_host_expanded: Optional[List[List[tuple]]] = None,
):
    """Merge the processes' payloads, keeping each image's from the FIRST
    process that evaluated it: the padded per-process shards evaluate up
    to P-1 images twice. ``per_host_ids`` lists every image a process
    evaluated, zero-detection images included. ``per_host_expanded``
    holds each process's expanded-GT records ``(image_id, boxes[nv, 4])``,
    kept by the same rule, so an image's GT comes from the process whose
    detections were kept. Returns ``(results, expanded)``."""
    if per_host_expanded is None:
        per_host_expanded = [[] for _ in per_host_ids]
    seen: set = set()
    out: List[dict] = []
    out_exp: List[tuple] = []
    for ids, host_results, host_exp in zip(per_host_ids, per_host_results,
                                           per_host_expanded):
        fresh = {i for i in ids if i not in seen}
        for r in host_results:
            if r["image_id"] in fresh:
                out.append(r)
        claimed: set = set()
        for img_id, boxes in host_exp:
            # Within-process duplicates also keep the first occurrence.
            if img_id in fresh and img_id not in claimed:
                out_exp.append((img_id, boxes))
                claimed.add(img_id)
        seen.update(fresh)
    return out, out_exp


def merge_results_across_hosts(
    results: List[dict],
    evaluated_ids: List[int],
    expanded_records: Optional[List[tuple]] = None,
):
    """Every process's detections, evaluated ids and expanded-GT records,
    gathered to every process with ``all_gather_object`` and merged by
    ``merge_host_payloads``. Returns ``(results, expanded_records)``."""
    if process_count() == 1:
        if expanded_records is None:
            return results, []
        return merge_host_payloads([evaluated_ids], [results],
                                   [expanded_records])
    payload = (results, [int(i) for i in evaluated_ids],
               [(int(i), np.asarray(b)) for i, b in expanded_records or []])
    gathered = [None] * process_count()
    dist.all_gather_object(gathered, payload)
    per_host_results, per_host_ids, per_host_expanded = zip(*gathered)
    return merge_host_payloads(list(per_host_ids), list(per_host_results),
                               list(per_host_expanded))


def evaluate_coco(
    eval_step,
    model,
    loader,
    coco_gt: COCOIndex,
    expand_target_boxes: bool = False,
    print_freq: int = 100,
    early_stop: Optional[int] = None,
    header: str = "Test:",
    image_output_dir: Optional[str] = None,
    seed: int = 1337,
) -> Tuple[np.ndarray, Dict]:
    """Run the loop; returns the 19-stat vector (``STAT_NAMES``, AP first)
    and the loop's measurements.

    ``eval_step(model, batch, generator)`` returns (Detections, GT boxes).
    ``generator``, on the model's device, is seeded anew each iteration
    from (``seed``, process index, iteration), the counterpart of JAX's
    ``fold_in``: the eval-time dilation and corruptions draw fresh values
    every step, and the whole eval stays deterministic. The
    measurements, also printed as one ``eval loop:`` line of JSON:
    images, detections collected, wall-clock seconds and images per
    second; on CUDA (``null`` elsewhere) the wall ms per image of the
    steps, between CUDA events around each step (the steps wait on the
    host, so this is not the device's busy time), and the share of the
    wall clock spent outside the steps (loader, detection collection).

    With ``image_output_dir`` the first image of each of the first 50
    iterations is written there with its detections drawn
    (``utils/visualization.py``), as JAX's loop does: the batch's source
    canvas, that is the image before blur, padded to its source bucket."""
    results: List[dict] = []
    evaluated_ids: List[int] = []
    expanded_records: List[tuple] = []
    gt = coco_gt
    if expand_target_boxes:
        gt = COCOIndex(copy.deepcopy(coco_gt.dataset))

    on_cuda = model.device.type == "cuda"
    events = []
    logger = MetricLogger()
    t0 = time.perf_counter()
    for it, (batch, _bucket, image_ids) in enumerate(
        logger.log_every(loader, print_freq, header)
    ):
        if early_stop is not None and it >= early_stop:
            break
        if on_cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        generator = torch.Generator(device=model.device)
        generator.manual_seed(int(np.random.SeedSequence(
            [seed, process_index(), it]).generate_state(1)[0]))
        dets, expanded_gt = eval_step(model, batch, generator)
        if on_cuda:
            ev[1].record()
            events.append(ev)
        evaluated_ids.extend(int(i) for i in image_ids)
        collect_detections(dets, image_ids, results)
        if image_output_dir is not None and it < 50:
            dump_detections(image_output_dir, int(image_ids[0]),
                            batch.images[0].cpu().numpy(), dets)
        if expand_target_boxes:
            # Record, don't rewrite yet: the rewrite happens after the
            # cross-process merge, against the merged records.
            eg = expanded_gt.cpu().numpy()
            nv = batch.gt_valid.sum(dim=1).tolist()
            for i, img_id in enumerate(image_ids):
                expanded_records.append((int(img_id), eg[i, : nv[i]].copy()))
    if on_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(evaluated_ids)
    step_ms = (sum(a.elapsed_time(b) for a, b in events) / max(n, 1)
               if on_cuda else None)
    summary = {"images": n, "detections": len(results), "wall_s": wall,
               "img_s": n / wall if wall else 0.0,
               "step_ms_per_image": step_ms,
               "share_outside_steps": (1.0 - step_ms * n / 1e3 / wall)
               if on_cuda and wall else None}
    print("eval loop: " + json.dumps(summary))

    results, expanded_records = merge_results_across_hosts(
        results, evaluated_ids,
        expanded_records if expand_target_boxes else None)
    faulty = 0
    for img_id, boxes in expanded_records:
        faulty += rewrite_expanded_gt(gt, img_id, boxes, len(boxes))
    if faulty:
        print(f"expanded-GT rewrite: {faulty} faulty boxes")
    if not results:
        print("no detections produced")
        return np.full(len(STAT_NAMES), -1.0), summary
    dt = gt.load_res(results)
    ev = COCOEval(gt, dt, "bbox")
    ev.evaluate()
    ev.accumulate()
    stats = ev.summarize()
    ev.print_summary()
    return stats, summary
