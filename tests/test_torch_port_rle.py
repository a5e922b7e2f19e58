"""The port's RLE masks, ``segm`` and ``keypoints`` evaluation and the
COCO items with masks and keypoints, held against the JAX package on the
CPU: the RLE ops exactly on seeded masks, polygons and strings, the
``segm`` and keypoint (OKS) COCOeval stats within 1e-12 on seeded GT and
results with crowd regions, unlabelled-keypoint GT and empty images,
``load_res``'s segmentation and keypoint branches, and
``CocoDetection(with_masks=, with_keypoints=)`` items array for array."""

import copy
import os

import numpy as np
import pytest

from synthetic_coco import COCO_SIZES, write_coco_kp

from detectinblur_tpu.data.coco import CocoDetection as JaxCocoDetection
from detectinblur_tpu.data.coco import get_coco_kp as jax_get_coco_kp
from detectinblur_tpu.eval import rle as jax_rle
from detectinblur_tpu.eval.coco_eval import COCOEval as JaxCOCOEval
from detectinblur_tpu.eval.coco_eval import KPT_SIGMAS as JAX_KPT_SIGMAS
from detectinblur_tpu.eval.coco_index import COCOIndex as JaxCOCOIndex
from detectinblur_tpu_torch.data.coco import CocoDetection, get_coco_kp
from detectinblur_tpu_torch.eval import rle
from detectinblur_tpu_torch.eval.coco_eval import (
    KPT_SIGMAS,
    KPT_STAT_NAMES,
    COCOEval,
)
from detectinblur_tpu_torch.eval.coco_index import COCOIndex


def _blobs(rng, h, w, n):
    """``n`` masks of 1-3 random rectangles with salt noise."""
    out = []
    for _ in range(n):
        m = np.zeros((h, w), np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            y1 = y0 + rng.integers(1, h // 2 + 2)
            x1 = x0 + rng.integers(1, w // 2 + 2)
            m[y0:y1, x0:x1] = 1
        m[rng.random((h, w)) < 0.02] ^= 1
        out.append(m)
    return out


def _masks(rng):
    """Random blobs plus the edge cases: empty, full, a first pixel set,
    a last pixel set, one column."""
    ms = _blobs(rng, 37, 23, 8)
    edge = [np.zeros((37, 23), np.uint8), np.ones((37, 23), np.uint8)]
    first = np.zeros((37, 23), np.uint8)
    first[0, 0] = 1
    last = np.zeros((37, 23), np.uint8)
    last[-1, -1] = 1
    col = np.zeros((37, 23), np.uint8)
    col[:, 5] = 1
    return ms + edge + [first, last, col]


def _counts(r):
    return [int(c) for c in r["counts"]]


def test_codec_encode_decode_area_bbox_match_jax():
    rng = np.random.default_rng(0)
    for m in _masks(rng) + [np.zeros((0, 5), np.uint8)]:
        ours, ref = rle.encode(m), jax_rle.encode(m)
        assert ours["size"] == ref["size"]
        assert _counts(ours) == _counts(ref)
        if not m.size:
            continue
        for r in (ref, {"size": ref["size"],
                        "counts": jax_rle.toString(ref["counts"])}):
            d = rle.decode(r)
            assert d.dtype == np.uint8
            np.testing.assert_array_equal(d, jax_rle.decode(r))
            np.testing.assert_array_equal(d, m)
            assert rle.area(r) == jax_rle.area(r) == int(m.sum())
            b, jb = rle.toBbox(r), jax_rle.toBbox(r)
            assert b.dtype == jb.dtype
            np.testing.assert_array_equal(b, jb)
        s = rle.toString(ours["counts"])
        assert s == jax_rle.toString(ref["counts"])
        np.testing.assert_array_equal(rle.frString(s), jax_rle.frString(s))
        np.testing.assert_array_equal(rle.frString(s.decode()),
                                      np.asarray(_counts(ref)))
    # Counts whose deltas are large and negative, through the varint code.
    counts = [0, 5000, 3, 70000, 1, 2, 123456, 7]
    s = rle.toString(counts)
    assert s == jax_rle.toString(counts)
    assert rle.frString(s).tolist() == counts


def test_merge_iou_and_nms_match_jax():
    rng = np.random.default_rng(1)
    ms = _masks(rng)
    rles = [jax_rle.encode(m) for m in ms]
    for intersect in (False, True):
        for group in (rles[:1], rles[:3], rles[2:7]):
            ours = rle.merge(group, intersect)
            assert _counts(ours) == _counts(jax_rle.merge(group, intersect))
    assert rle.merge([]) == jax_rle.merge([])
    strings = [{"size": r["size"], "counts": jax_rle.toString(r["counts"])}
               for r in rles]
    crowd = np.array([0, 1, 0, 1, 1])
    for dts, gts in ((rles, rles[:5]), (strings[3:], strings[:5]),
                     (rles[:1], strings[:5]), ([], rles[:5])):
        ours = rle.iou_matrix(dts, gts, crowd)
        ref = jax_rle.iou_matrix(dts, gts, crowd)
        assert ours.shape == ref.shape == (len(dts), 5)
        np.testing.assert_array_equal(ours, ref)
    want = np.array([[(a & b).sum() / ((a.sum() if c else (a | b).sum()) or 1)
                      for b, c in zip(ms[:5], crowd)] for a in ms])
    np.testing.assert_allclose(rle.iou_matrix(rles, rles[:5], crowd), want,
                               rtol=1e-15)
    assert rle.iou_matrix(rles, [], []).shape == (len(rles), 0)
    for thr in (0.0, 0.3, 0.7):
        np.testing.assert_array_equal(rle.rleNms(rles, thr),
                                      jax_rle.rleNms(rles, thr))
        boxes = np.stack([jax_rle.toBbox(r) for r in rles])
        np.testing.assert_array_equal(rle.bbNms(boxes, thr),
                                      jax_rle.bbNms(boxes, thr))
    assert rle.rleNms([], 0.5).shape == (0,)


def test_polygons_match_jax():
    rng = np.random.default_rng(2)
    h, w = 41, 53
    polys = []
    for n in (3, 4, 5, 8, 12):
        t = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(4, 20, n)                # star-shaped, often concave
        cx, cy = rng.uniform(10, 40), rng.uniform(10, 30)
        polys.append(np.stack([cx + r * np.cos(t), cy + r * np.sin(t)],
                              1).ravel().tolist())
    polys.append([1.0, 1.0, 30.0, 2.0])          # fewer than 3 points
    polys.append([-5.0, -5.0, 60.0, 10.0, 20.0, 50.0])   # past the edges
    for p in polys:
        assert _counts(rle.frPoly(p, h, w)) == _counts(jax_rle.frPoly(p, h, w))
    for parts in (polys[:2], polys[2:5], polys):
        assert (_counts(rle.frPolys(parts, h, w))
                == _counts(jax_rle.frPolys(parts, h, w)))
        np.testing.assert_array_equal(
            rle.masks_from_segmentation(parts, h, w),
            jax_rle.masks_from_segmentation(parts, h, w))
    r = jax_rle.frPolys(polys[:3], h, w)
    np.testing.assert_array_equal(rle.masks_from_segmentation(r, h, w),
                                  jax_rle.masks_from_segmentation(r, h, w))
    for mod in (rle, jax_rle):
        with pytest.raises(TypeError):
            mod.masks_from_segmentation("counts", h, w)


# ------------------------------------------------------------- COCOeval
def _segm_coco(rng, n_images=8):
    """GT RLE masks (polygons rasterized by JAX, some crowd), results:
    jittered or dilated copies with random scores (compressed strings,
    with their masks' boxes), some on the wrong category, and false
    positives; images 4 and 8 have no GT."""
    h, w = 48, 64
    images, gts, dets = [], [], []
    for img_id in range(1, n_images + 1):
        images.append({"id": img_id, "height": h, "width": w})
        n = 0 if img_id % 4 == 0 else int(rng.integers(1, 5))
        for _ in range(n):
            cx, cy = rng.uniform(8, 56), rng.uniform(8, 40)
            s = rng.choice([3.0, 8.0, 16.0])
            t = np.sort(rng.uniform(0, 2 * np.pi, 6))
            poly = np.stack([cx + s * np.cos(t), cy + s * np.sin(t)], 1)
            g = jax_rle.frPoly(poly.ravel().tolist(), h, w)
            crowd = int(rng.random() < 0.15)
            cat = int(rng.integers(1, 4))
            gts.append({"image_id": img_id, "category_id": cat,
                        "segmentation": g, "area": float(jax_rle.area(g)),
                        "bbox": jax_rle.toBbox(g).tolist(), "iscrowd": crowd})
            if rng.random() < 0.85:
                m = jax_rle.decode(g)
                m = np.roll(m, tuple(rng.integers(-2, 3, 2)), (0, 1))
                if rng.random() < 0.5:
                    m = m | np.roll(m, 1, 0)
                d = jax_rle.encode(m)
                dets.append({"image_id": img_id, "category_id": cat
                             if rng.random() < 0.9 else int(rng.integers(1, 4)),
                             "segmentation": {"size": [h, w], "counts":
                                              jax_rle.toString(d["counts"])},
                             "bbox": jax_rle.toBbox(d).tolist(),
                             "score": float(rng.random())})
        for m in _blobs(rng, h, w, int(rng.integers(0, 3))):
            d = jax_rle.encode(m)
            dets.append({"image_id": img_id,
                         "category_id": int(rng.integers(1, 4)),
                         "segmentation": {"size": [h, w], "counts":
                                          jax_rle.toString(d["counts"])},
                         "bbox": jax_rle.toBbox(d).tolist(),
                         "score": float(rng.random())})
    for k, a in enumerate(gts, start=1):
        a["id"] = k
    cats = [{"id": c} for c in (1, 2, 3)]
    return {"images": images, "annotations": gts, "categories": cats}, dets


def _stats(index_cls, eval_cls, gt_json, dets, iou_type):
    gt = index_cls(copy.deepcopy(gt_json))
    ev = eval_cls(gt, gt.load_res(copy.deepcopy(dets)), iou_type)
    ev.evaluate()
    ev.accumulate()
    return ev.summarize(), ev


@pytest.mark.parametrize("seed", [0, 1])
def test_segm_stats_match_jax(seed):
    gt_json, dets = _segm_coco(np.random.default_rng(seed))
    ours, ev = _stats(COCOIndex, COCOEval, gt_json, dets, "segm")
    ref, jev = _stats(JaxCOCOIndex, JaxCOCOEval, gt_json, dets, "segm")
    assert ours.shape == (19,) and ours[0] > 0
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    for k in ("precision", "recall", "scores"):
        np.testing.assert_allclose(ev.eval[k], jev.eval[k], rtol=0, atol=1e-12)


def test_segm_polygon_gt_is_rasterized_where_jax_fails():
    """A GT segmentation given as polygons (COCO's instances files):
    JAX's segm reads it as an RLE and raises TypeError; the port
    rasterizes it on the image's canvas, and gives the stats JAX gives on
    the same GT as RLEs."""
    rng = np.random.default_rng(3)
    gt_json, dets = _segm_coco(rng)
    as_polys = copy.deepcopy(gt_json)
    for a in as_polys["annotations"]:
        if not a["iscrowd"]:
            m = jax_rle.decode(a["segmentation"])
            ys, xs = np.nonzero(m)
            a["segmentation"] = [[float(xs.min()), float(ys.min()),
                                  float(xs.max() + 1), float(ys.min()),
                                  float(xs.max() + 1), float(ys.max() + 1),
                                  float(xs.min()), float(ys.max() + 1)]]
    with pytest.raises(TypeError):
        _stats(JaxCOCOIndex, JaxCOCOEval, as_polys, dets, "segm")
    rasterized = copy.deepcopy(as_polys)
    for a in rasterized["annotations"]:
        if isinstance(a["segmentation"], list):
            a["segmentation"] = jax_rle.frPolys(a["segmentation"], 48, 64)
    ours, _ = _stats(COCOIndex, COCOEval, as_polys, dets, "segm")
    ref, _ = _stats(JaxCOCOIndex, JaxCOCOEval, rasterized, dets, "segm")
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    # The caller's GT keeps its polygons.
    assert sum(isinstance(a["segmentation"], list)
               for a in as_polys["annotations"]) > 5


def test_segm_results_without_boxes_get_theirs_where_jax_fails():
    """COCO's segm result format carries no box: JAX's ``load_res`` adds
    none and its matching raises KeyError on it; the port's adds the
    mask's box, as pycocotools does, and gives the stats JAX gives when
    handed that box and the mask's area."""
    gt_json, dets = _segm_coco(np.random.default_rng(6))
    bare = [{k: v for k, v in d.items() if k != "bbox"} for d in dets]
    with pytest.raises(KeyError, match="bbox"):
        _stats(JaxCOCOIndex, JaxCOCOEval, gt_json, bare, "segm")
    given = [dict(d, area=float(jax_rle.area(d["segmentation"])))
             for d in dets]
    ours, _ = _stats(COCOIndex, COCOEval, gt_json, bare, "segm")
    ref, _ = _stats(JaxCOCOIndex, JaxCOCOEval, gt_json, given, "segm")
    assert ours[0] > 0
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    res = COCOIndex(gt_json).load_res(bare)
    assert [a["bbox"] for a in res.dataset["annotations"]] == [
        d["bbox"] for d in dets]


def _kp_coco(rng, n_images=10):
    """Person GT with 17 keypoints (some unlabelled, some GT with none
    labelled, some crowd), areas over the medium and large ranges, and
    keypoint results without boxes: noisy copies of most GT plus false
    positives; images 5 and 10 have no GT."""
    images, gts, dets = [], [], []
    for img_id in range(1, n_images + 1):
        images.append({"id": img_id, "height": 480, "width": 640})
        n = 0 if img_id % 5 == 0 else int(rng.integers(1, 5))
        for _ in range(n):
            side = rng.choice([40.0, 120.0, 300.0]) * rng.uniform(0.8, 1.2)
            x, y = rng.uniform(0, 300, 2)
            bw, bh = side * rng.uniform(0.5, 1.0, 2)
            v = np.where(rng.random(17) < 0.3, 0, rng.integers(1, 3, 17))
            if rng.random() < 0.15:
                v[:] = 0
            kx, ky = x + rng.uniform(0, bw, 17), y + rng.uniform(0, bh, 17)
            kps = np.stack([kx * (v > 0), ky * (v > 0), v], 1)
            gts.append({"image_id": img_id, "category_id": 1,
                        "bbox": [float(x), float(y), float(bw), float(bh)],
                        "area": float(0.7 * bw * bh),
                        "iscrowd": int(rng.random() < 0.1),
                        "keypoints": kps.ravel().tolist(),
                        "num_keypoints": int((v > 0).sum())})
            if rng.random() < 0.85:
                noise = rng.normal(0, 0.05 * side, (17, 2))
                d = np.stack([kx + noise[:, 0], ky + noise[:, 1],
                              np.ones(17)], 1)
                dets.append({"image_id": img_id, "category_id": 1,
                             "keypoints": d.ravel().tolist(),
                             "score": float(rng.random())})
        for _ in range(int(rng.integers(0, 3))):
            d = np.stack([rng.uniform(0, 640, 17), rng.uniform(0, 480, 17),
                          np.ones(17)], 1)
            dets.append({"image_id": img_id, "category_id": 1,
                         "keypoints": d.ravel().tolist(),
                         "score": float(rng.random())})
    # One GT without num_keypoints: the ignore rule counts its labels.
    del gts[0]["num_keypoints"]
    for k, a in enumerate(gts, start=1):
        a["id"] = k
    return {"images": images, "annotations": gts,
            "categories": [{"id": 1, "name": "person"}]}, dets


@pytest.mark.parametrize("seed", [0, 1])
def test_keypoint_stats_match_jax(seed):
    gt_json, dets = _kp_coco(np.random.default_rng(seed))
    ours, ev = _stats(COCOIndex, COCOEval, gt_json, dets, "keypoints")
    ref, jev = _stats(JaxCOCOIndex, JaxCOCOEval, gt_json, dets, "keypoints")
    assert ours.shape == (len(KPT_STAT_NAMES),) == (10,) and ours[0] > 0
    assert ev.max_dets == [20]
    np.testing.assert_array_equal(KPT_SIGMAS, JAX_KPT_SIGMAS)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    for k in ("precision", "recall"):
        np.testing.assert_allclose(ev.eval[k], jev.eval[k], rtol=0, atol=1e-12)
    # The GT index is read, never changed, and the unlabelled GT ignored.
    assert all("ignore" not in a for a in ev.coco_gt.dataset["annotations"])
    none = [a for a in ev.coco_gt.dataset["annotations"]
            if not np.count_nonzero(np.asarray(a["keypoints"])[2::3])]
    assert none and all(g["ignore"] for k in ev._gts for g in ev._gts[k]
                        if g["id"] in {a["id"] for a in none})


def test_load_res_segmentation_and_keypoint_branches():
    """Areas from the RLE (unless a box gives one), a keypoint result's
    tight keypoint box and its area, ids from 1, as JAX's ``load_res``."""
    gt_json, sdets = _segm_coco(np.random.default_rng(4), n_images=3)
    _, kdets = _kp_coco(np.random.default_rng(4), n_images=3)
    with_box = dict(sdets[0], bbox=[1.0, 2.0, 3.0, 4.0])
    with_area = dict(kdets[0], area=7.0)
    for results in (sdets, kdets, [with_box, with_area]):
        ours = COCOIndex(copy.deepcopy(gt_json)).load_res(copy.deepcopy(results))
        ref = JaxCOCOIndex(copy.deepcopy(gt_json)).load_res(copy.deepcopy(results))
        assert ours.dataset["annotations"] == ref.dataset["annotations"]
        assert sorted(ours.anns) == sorted(ref.anns)
    got = COCOIndex(gt_json).load_res([with_box, with_area])
    assert got.anns[1]["area"] == 12.0          # from the box
    assert got.anns[2]["area"] != 7.0           # the keypoint box's


def test_segm_and_keypoints_raise_as_jax():
    """What neither mode can read raises in both packages: an unknown iou
    type (ValueError), a segmentation that is neither polygons nor RLE
    (TypeError), a keypoint result with no keypoint (ValueError)."""
    gt_json, _ = _segm_coco(np.random.default_rng(5), n_images=2)
    first = gt_json["annotations"][0]
    bad = copy.deepcopy(gt_json)
    bad["annotations"][0]["segmentation"] = "not a mask"
    det = {"image_id": first["image_id"], "category_id": first["category_id"],
           "score": 1.0, "segmentation": first["segmentation"]}
    for index_cls, eval_cls in ((COCOIndex, COCOEval),
                                (JaxCOCOIndex, JaxCOCOEval)):
        gt = index_cls(copy.deepcopy(gt_json))
        with pytest.raises(ValueError):
            ev = eval_cls(gt, gt.load_res([det]), "boxes")
            ev.evaluate()
        with pytest.raises(TypeError):
            _stats(index_cls, eval_cls, bad, [det], "segm")
        with pytest.raises(ValueError):
            gt.load_res([{"image_id": 1, "category_id": 1, "keypoints": [],
                          "score": 1.0}])


# ------------------------------------------------------------ COCO items
SPLITS = {"train2017": [COCO_SIZES[0], (64, 80)],
          "val2017": [(72, 96), COCO_SIZES[4], (60, 60)]}


@pytest.fixture(scope="module")
def kp_root(tmp_path_factory):
    return write_coco_kp(str(tmp_path_factory.mktemp("coco_kp")), SPLITS,
                         seed=3, persons=(1, 3), extras=True)


@pytest.mark.parametrize("split", ["train", "val"])
def test_coco_kp_items_with_masks_and_keypoints_match_jax(kp_root, split):
    """``get_coco_kp`` items, and items with masks and keypoints from
    polygons, an uncompressed RLE crowd region (dropped) and annotations
    of 17 and 5 keypoints (padded to 17), equal to JAX's array for
    array; the val split's empty image gives [0, H, W] masks and
    [0, 0, 3] keypoints."""
    folder = os.path.join(kp_root, f"{split}2017")
    ann = os.path.join(kp_root, "annotations",
                       f"person_keypoints_{split}2017.json")
    pairs = [(get_coco_kp(kp_root, split), jax_get_coco_kp(kp_root, split)),
             (CocoDetection(folder, ann, with_masks=True, with_keypoints=True),
              JaxCocoDetection(folder, ann, with_masks=True,
                               with_keypoints=True))]
    for ours, ref in pairs:
        assert ours.ids == ref.ids and len(ours) == len(ref) > 0
        for i in range(len(ours)):
            o, r = ours[i], ref[i]
            assert set(o) == set(r)
            assert o["image_id"] == r["image_id"]
            for k in set(o) - {"image_id"}:
                assert o[k].dtype == r[k].dtype, k
                np.testing.assert_array_equal(o[k], r[k], err_msg=k)
    items = [pairs[1][0][i] for i in range(len(pairs[1][0]))]
    assert all(it["keypoints"].shape[1:] == (17, 3) for it in items
               if len(it["boxes"]))
    assert all(it["masks"].shape == (len(it["boxes"]),)
               + it["image"].shape[:2] for it in items)
    if split == "val":
        assert items[0]["masks"].any(axis=(1, 2)).all()
        assert items[-1]["keypoints"].shape == (0, 0, 3)


def test_coco_masks_and_keypoints_raise_as_jax(tmp_path, kp_root):
    """A segmentation neither polygons nor RLE (TypeError) and keypoints
    not in threes (ValueError) raise in both packages' items."""
    import json

    ann = json.load(open(os.path.join(kp_root, "annotations",
                                      "person_keypoints_val2017.json")))
    first = [a for a in ann["annotations"]
             if a["image_id"] == 1 and not a["iscrowd"]]
    first[0]["segmentation"] = "not a mask"
    first[1]["keypoints"] = [1.0, 2.0]
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(ann))
    folder = os.path.join(kp_root, "val2017")
    for cls in (CocoDetection, JaxCocoDetection):
        with pytest.raises(TypeError):
            cls(folder, str(path), with_masks=True)[0]
        with pytest.raises(ValueError):
            cls(folder, str(path), with_keypoints=True)[0]
