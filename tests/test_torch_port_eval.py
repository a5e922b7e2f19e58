"""The port's evaluation path held against the JAX package on the CPU:
COCOeval and its 19 stats, the GT index helpers, the eval loop with a
stub step, the eval step itself on one blurred, expanded batch, the
cross-process merge in a 2-process gloo group, and the loggers."""

import copy
import multiprocessing
import socket
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_coco import write_coco
from torch_reference import make_random_fasterrcnn_sd
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

import detectinblur_tpu.data.batching as jax_batching
from detectinblur_tpu.data import blur_sampling as jax_bs
from detectinblur_tpu.data.coco import get_coco as jax_get_coco
from detectinblur_tpu.data.loader import DetectionLoader as JaxLoader
from detectinblur_tpu.eval.coco_eval import COCOEval as JaxCOCOEval
from detectinblur_tpu.eval.coco_index import COCOIndex as JaxCOCOIndex
from detectinblur_tpu.models.faster_rcnn import Detections as JaxDetections
from detectinblur_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from detectinblur_tpu.models.faster_rcnn import (
    FasterRCNNConfig as JaxFasterRCNNConfig,
)
from detectinblur_tpu.models.roi_heads import BoxHeadConfig as JaxBoxHeadConfig
from detectinblur_tpu.models.rpn import RPNConfig as JaxRPNConfig
from detectinblur_tpu.train import engine as jax_engine
from detectinblur_tpu.train import eval_loop as jax_eval_loop
from detectinblur_tpu.utils.torch_convert import convert_fasterrcnn_state_dict
import detectinblur_tpu_torch.data.batching as batching
from detectinblur_tpu_torch.data import blur_sampling as bs
from detectinblur_tpu_torch.data.coco import get_coco
from detectinblur_tpu_torch.data.loader import DetectionLoader
from detectinblur_tpu_torch.eval.coco_eval import COCOEval, STAT_NAMES
from detectinblur_tpu_torch.eval.coco_index import COCOIndex
from detectinblur_tpu_torch.models.faster_rcnn import (
    Detections,
    FasterRCNN,
    FasterRCNNConfig,
)
from detectinblur_tpu_torch.models.roi_heads import BoxHeadConfig
from detectinblur_tpu_torch.models.rpn import RPNConfig
from detectinblur_tpu_torch.train import engine, eval_loop
from detectinblur_tpu_torch.utils.convert import params_from_jax


def _random_coco(rng, n_images=12, n_cats=4):
    """GT over three area ranges with crowd boxes and empty images, and
    detections: jittered copies of most GT boxes with random scores, some
    on the wrong class, plus false positives (also on GT-free images)."""
    images, gts, dets = [], [], []
    for img_id in range(1, n_images + 1):
        images.append({"id": img_id, "height": 400, "width": 500})
        n = 0 if img_id % 5 == 0 else int(rng.integers(1, 8))
        for _ in range(n):
            side = rng.choice([12.0, 50.0, 150.0]) * rng.uniform(0.7, 1.3)
            x, y = rng.uniform(0, 300, 2)
            box = [float(x), float(y), float(side * rng.uniform(0.6, 1.4)),
                   float(side * rng.uniform(0.6, 1.4))]
            cat = int(rng.integers(1, n_cats + 1))
            crowd = int(rng.random() < 0.1)
            gts.append({"image_id": img_id, "category_id": cat, "bbox": box,
                        "area": box[2] * box[3], "iscrowd": crowd})
            if rng.random() < 0.85:
                jit = rng.normal(0, 0.08 * side, 4)
                dets.append({"image_id": img_id,
                             "category_id": cat if rng.random() < 0.9
                             else int(rng.integers(1, n_cats + 1)),
                             "bbox": [box[0] + jit[0], box[1] + jit[1],
                                      max(box[2] + jit[2], 1.0),
                                      max(box[3] + jit[3], 1.0)],
                             "score": float(rng.random())})
        for _ in range(int(rng.integers(0, 4))):
            x, y = rng.uniform(0, 400, 2)
            dets.append({"image_id": img_id,
                         "category_id": int(rng.integers(1, n_cats + 1)),
                         "bbox": [float(x), float(y), float(rng.uniform(5, 90)),
                                  float(rng.uniform(5, 90))],
                         "score": float(rng.random())})
    for k, a in enumerate(gts, start=1):
        a["id"] = k
    return ({"images": images, "annotations": gts,
             "categories": [{"id": c} for c in range(1, n_cats + 1)]}, dets)


def _stats(index_cls, eval_cls, gt_json, dets):
    gt = index_cls(copy.deepcopy(gt_json))
    ev = eval_cls(gt, gt.load_res(dets), "bbox")
    ev.evaluate()
    ev.accumulate()
    return ev.summarize(), ev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_eval_matches_jax(seed):
    """19 stats within 1e-12 of the JAX COCOEval, and the same precision
    tensor, on random GT (crowd boxes, empty images) with jittered,
    mislabelled and false-positive detections."""
    gt_json, dets = _random_coco(np.random.default_rng(seed))
    ours, ev = _stats(COCOIndex, COCOEval, gt_json, dets)
    ref, jev = _stats(JaxCOCOIndex, JaxCOCOEval, gt_json, dets)
    assert ours.shape == (19,) and len(STAT_NAMES) == 19
    assert 0 < ours[0] < 1
    np.testing.assert_allclose(ours, ref, atol=1e-12, rtol=0)
    np.testing.assert_allclose(ev.eval["precision"], jev.eval["precision"],
                               atol=1e-12, rtol=0)


def test_coco_eval_of_the_gt_itself_is_perfect():
    gt_json, _ = _random_coco(np.random.default_rng(4))
    for a in gt_json["annotations"]:
        a["iscrowd"] = 0
    dets = [{"image_id": a["image_id"], "category_id": a["category_id"],
             "bbox": list(a["bbox"]), "score": 1.0}
            for a in gt_json["annotations"]]
    stats, _ = _stats(COCOIndex, COCOEval, gt_json, dets)
    assert stats[0] == 1.0 and stats[1] == 1.0 and stats[8] == 1.0


def test_segm_and_keypoints_raise():
    """Segmentation and keypoint results the index cannot read raise as
    JAX's do: a segmentation that is not an RLE (TypeError), a keypoint
    result with no keypoint (ValueError); so does an unknown iou type."""
    for index_cls in (COCOIndex, JaxCOCOIndex):
        gt = index_cls({"images": [{"id": 1}], "annotations": [],
                        "categories": [{"id": 1}]})
        with pytest.raises(TypeError):
            gt.load_res([{"image_id": 1, "category_id": 1,
                          "segmentation": [1, 2, 3], "score": 1.0}])
        with pytest.raises(ValueError):
            gt.load_res([{"image_id": 1, "category_id": 1, "keypoints": [],
                          "score": 1.0}])
    with pytest.raises(ValueError, match="boxes"):
        COCOEval(gt, gt, "boxes")


def test_coco_index_lookups_match_jax():
    gt_json, dets = _random_coco(np.random.default_rng(5))
    ours, ref = COCOIndex(copy.deepcopy(gt_json)), JaxCOCOIndex(copy.deepcopy(gt_json))
    assert ours.get_img_ids() == ref.get_img_ids()
    assert ours.get_cat_ids() == ref.get_cat_ids()
    for q in (dict(), dict(img_ids=[1, 2]), dict(cat_ids=[3]),
              dict(img_ids=[3, 4], cat_ids=[1, 2])):
        assert ours.get_ann_ids(**q) == ref.get_ann_ids(**q)
    assert ours.load_res(dets).dataset == ref.load_res(dets).dataset


SPLITS = {"val2017": [(40, 48), (48, 40), (44, 44), (36, 48), (40, 40)]}


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return write_coco(str(tmp_path_factory.mktemp("coco")), SPLITS, seed=2,
                      n_cats=5, boxes=(0, 4), extras=True)


def test_dataset_to_coco_index_and_rewrite_match_jax(coco_root):
    """Exact GT index from the dataset's items, and the positional
    expanded-GT rewrite with its faulty count (fewer expanded boxes than
    annotations)."""
    ours = eval_loop.dataset_to_coco_index(get_coco(coco_root, "val"))
    ref = jax_eval_loop.dataset_to_coco_index(jax_get_coco(coco_root, "val"))
    assert ours.dataset == ref.dataset
    rng = np.random.default_rng(0)
    for img_id in ours.get_img_ids():
        n = len(ours.img_to_anns[img_id])
        boxes = rng.uniform(0, 40, (n, 4)).astype(np.float32)
        nv = max(n - 1, 0)
        assert eval_loop.rewrite_expanded_gt(ours, img_id, boxes, nv) == \
            jax_eval_loop.rewrite_expanded_gt(ref, img_id, boxes, nv)
    assert ours.dataset == ref.dataset


def _stub_dets(batch, image_id, n_fp=3):
    """Deterministic detections for one image: its GT boxes jittered (by
    a seed of its id) with random scores, plus ``n_fp`` false positives."""
    gt = np.asarray(batch.gt_boxes)[0]
    (h, w), = np.asarray(batch.hw)
    r = np.random.default_rng(int(image_id))
    fp = r.uniform(0, 0.5, (n_fp, 4)) * (w, h, w, h)
    fp[:, 2:] += r.uniform(0.2, 0.5, (n_fp, 2)) * (w, h)
    boxes = np.concatenate([gt + r.normal(0, 2, gt.shape), fp])
    labels = np.concatenate([np.asarray(batch.gt_labels)[0],
                             r.integers(1, 6, n_fp)])
    valid = np.concatenate([np.asarray(batch.gt_valid)[0], np.ones(n_fp, bool)])
    scores = r.random(len(boxes))
    return [a[None] for a in (boxes.astype(np.float32), scores.astype(np.float32),
                              labels.astype(np.int32), valid)]


@pytest.mark.parametrize("expand", [False, True])
def test_evaluate_coco_matches_jax(coco_root, monkeypatch, expand):
    """``evaluate_coco`` of both packages, each driven by its own loader
    over the same val set and a stub step that returns the same
    detections and (with ``expand``) the same shifted GT boxes: the same
    19 stats."""
    monkeypatch.setattr(batching, "DEFAULT_SOURCE_BUCKETS", ((48, 48),))
    monkeypatch.setattr(jax_batching, "DEFAULT_SOURCE_BUCKETS", ((48, 48),))
    ids_seen = []

    def port_step(model, batch, generator):
        assert isinstance(generator, torch.Generator)
        d = _stub_dets(batch, ids_seen[-1])
        return (Detections(*(torch.from_numpy(a) for a in d)),
                batch.gt_boxes + 1.5)

    def jax_step(params, batch, key):
        d = _stub_dets(batch, ids_seen[-1])
        return JaxDetections(*(jnp.asarray(a) for a in d)), batch.gt_boxes + 1.5

    class Tap:
        """Pass the loader through, noting each batch's image id."""
        def __init__(self, it):
            self.it = it

        def __len__(self):
            return len(self.it)

        def __iter__(self):
            for batch, bucket, ids in self.it:
                ids_seen.append(ids[0])
                yield batch, bucket, ids

    ds, jds = get_coco(coco_root, "val"), jax_get_coco(coco_root, "val")
    model = types.SimpleNamespace(device=torch.device("cpu"))
    ours, loop = eval_loop.evaluate_coco(
        port_step, model, Tap(DetectionLoader(ds, 1, shuffle=False,
                                              drop_last=False)),
        ds.index, expand_target_boxes=expand)
    ref = jax_eval_loop.evaluate_coco(
        jax_step, None, Tap(JaxLoader(jds, 1, shuffle=False, drop_last=False)),
        jds.index, expand_target_boxes=expand)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-12, rtol=0)
    assert 0 < ours[1] < 1
    assert loop["images"] == len(ds) and loop["step_ms_per_image"] is None
    assert loop["detections"] >= 3 * len(ds)   # the stub's false positives
    # The caller's GT index is left as it was.
    assert ds.index.dataset == get_coco(coco_root, "val").index.dataset


# ---------------------------------------------------------- the eval step
BUCKET = (128, 160)


def test_eval_step_matches_jax():
    """make_eval_step of both packages on one blurred batch with GT
    expansion, weights carried by params_from_jax: the expanded GT within
    1e-4 px, and 85% of the JAX valid detections matched by label, IoU >
    0.95 and score within 2e-3 (tests/test_torch_port_model.py's
    tolerances)."""
    sd = make_random_fasterrcnn_sd(np.random.default_rng(0))
    jparams = convert_fasterrcnn_state_dict(sd)
    rpn = dict(pre_nms_top_n_test=400, post_nms_top_n_test=200)
    jmodel = JaxFasterRCNN(JaxFasterRCNNConfig(
        min_size=BUCKET[0], max_size=BUCKET[1], rpn=JaxRPNConfig(**rpn),
        box=JaxBoxHeadConfig(nms_pool=2048)))
    model = FasterRCNN(FasterRCNNConfig(
        min_size=BUCKET[0], max_size=BUCKET[1], rpn=RPNConfig(**rpn),
        box=BoxHeadConfig(nms_pool=2048), precision="highest"), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))

    rng = np.random.default_rng(3)
    items = []
    for k, (h, w) in enumerate([(110, 150), (128, 100)]):
        boxes = rng.uniform(0, 50, (4, 4)).astype(np.float32)
        boxes[:, 2:] += rng.uniform(10, 50, (4, 2))
        items.append({"image": (rng.random((h, w, 3)) * 255).astype(np.uint8),
                      "image_id": k + 1, "boxes": boxes,
                      "labels": rng.integers(1, 91, 4).astype(np.int32)})
    bank = bs.generate_psf_bank(torch.Generator().manual_seed(7), bank_size=2,
                                iters=300)
    decisions = [(True, 0, 3, 1), (True, 2, 4, 0)]
    batch = batching.build_blur_batch(
        items, [bs.BlurDecision(*d) for d in decisions], bank, BUCKET)
    jbatch = jax_batching.build_blur_batch(
        items, [jax_bs.BlurDecision(*d) for d in decisions], bank, BUCKET)

    step = engine.make_eval_step(model, BUCKET, blur_eval=True,
                                 expand_target_boxes=True)
    jstep = jax_engine.make_eval_step(jmodel, BUCKET, blur_eval=True,
                                      expand_target_boxes=True)
    dets, gt = step(model, batch)
    jdets, jgt = jstep(jparams, jbatch, jax.random.key(0))
    assert dets.boxes.shape == (2, 100, 4)
    assert not torch.equal(gt, batch.gt_boxes)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), atol=1e-4)
    for b in range(2):
        jv = np.asarray(jdets.valid[b])
        rb, rs, rl = (np.asarray(a[b])[jv] for a in (
            jdets.boxes, jdets.scores, jdets.labels))
        tv = dets.valid[b].numpy()
        ob, os_, ol = (a[b].numpy()[tv] for a in (
            dets.boxes, dets.scores, dets.labels))
        assert len(rb) > 10 and len(ob) > 10
        lt = np.maximum(rb[:, None, :2], ob[None, :, :2])
        rbt = np.minimum(rb[:, None, 2:], ob[None, :, 2:])
        inter = np.clip(rbt - lt, 0, None).prod(-1)
        area = lambda x: np.clip(x[:, 2:] - x[:, :2], 0, None).prod(-1)
        iou = inter / np.maximum(area(rb)[:, None] + area(ob)[None] - inter, 1e-9)
        iou = iou * (rl[:, None] == ol[None, :])
        best = iou.argmax(1)
        ok = ((iou[np.arange(len(rb)), best] > 0.95)
              & (np.abs(rs - os_[best]) < 2e-3))
        assert ok.mean() > 0.85, f"image {b}: {ok.mean():.2%} matched"
    with pytest.raises(ValueError, match="another model"):
        step(FasterRCNN(model.cfg, device="meta"), batch)


# ------------------------------------------------- across two processes
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _payloads():
    """Two processes' payloads: overlapping ids (the padded shards), an
    image with no detection, and expanded records."""
    r0 = [{"image_id": i, "category_id": 1, "bbox": [1.0, 2.0, 3.0, 4.0],
           "score": 0.5 + i / 100} for i in (1, 2, 2, 3)]
    r1 = [{"image_id": i, "category_id": 2, "bbox": [5.0, 6.0, 7.0, 8.0],
           "score": 0.1 * i} for i in (3, 4, 5, 1)]
    ids = [[1, 2, 3, 9], [3, 4, 5, 1]]
    exp = [[(1, np.full((2, 4), 1.0)), (2, np.full((1, 4), 2.0)),
            (3, np.full((3, 4), 3.0))],
           [(3, np.full((3, 4), 30.0)), (4, np.full((2, 4), 4.0)),
            (5, np.zeros((0, 4)))]]
    return [r0, r1], ids, exp


def _merge_worker(rank, port, out):
    import torch.distributed as dist

    from detectinblur_tpu_torch.train import eval_loop as el
    from detectinblur_tpu_torch.utils.metric_logger import MetricLogger

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        results, ids, exp = _payloads()
        merged = el.merge_results_across_hosts(results[rank], ids[rank],
                                               exp[rank])
        logger = MetricLogger()
        logger.update(loss=1.0 + rank)
        logger.update(loss=3.0)
        logger.synchronize_between_processes()
        out.put((rank, merged, logger.loss.count, logger.loss.total))
    finally:
        dist.destroy_process_group()


def test_merge_results_across_processes_gloo():
    """merge_results_across_hosts in a 2-process gloo group equals
    merge_host_payloads of both processes' lists on every process, and
    the metric logger sums [count, total] across them. Each process is
    joined with a timeout and killed on expiry, so a hang fails."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_merge_worker, args=(r, port, out))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, merged, count, total = out.get(timeout=120)
            got[rank] = (merged, count, total)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs)
    results, ids, exp = _payloads()
    want_r, want_e = eval_loop.merge_host_payloads(ids, results, exp)
    assert want_e and len(want_r) == 6
    for rank in (0, 1):
        (res, recs), count, total = got[rank]
        assert res == want_r
        assert [i for i, _ in recs] == [i for i, _ in want_e]
        for (_, a), (_, b) in zip(recs, want_e):
            np.testing.assert_array_equal(a, b)
        assert (count, total) == (4, 1.0 + 2.0 + 3.0 + 3.0)
    ref_r, ref_e = jax_eval_loop.merge_host_payloads(ids, results, exp)
    assert ref_r == want_r and [i for i, _ in ref_e] == [i for i, _ in want_e]


def test_scalar_writer_jsonl_without_tensorboard(tmp_path, monkeypatch):
    """Without tensorboard the writer falls back to JSONL, and it wipes
    its path first."""
    from detectinblur_tpu_torch.utils.logging import ScalarWriter

    path = tmp_path / "tb"
    path.mkdir()
    (path / "old").write_text("x")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = ScalarWriter(str(path))
    w.add_scalar("a/b", 0.5, 3)
    w.close()
    assert not (path / "old").exists()
    import json

    rows = [json.loads(l) for l in (path / "scalars.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [("a/b", 0.5, 3)]
    ScalarWriter(None).add_scalar("x", 1.0, 0)   # no path: a no-op
