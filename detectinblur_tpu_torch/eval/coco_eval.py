"""COCO evaluation in numpy: bbox with the repo's 19-stat summary, segm
and keypoints.

Copy of ``detectinblur_tpu/eval/coco_eval.py`` (``bbox_iou_crowd`` :50,
``COCOEval`` :72, ``_compute_oks`` :132, the patched ``summarize`` :331,
``print_summary``, ``STAT_NAMES``, ``KPT_SIGMAS``, ``KPT_STAT_NAMES``):

  * per-(image, category) greedy matching of score-sorted detections to
    ground truth at 10 IoU thresholds, with crowd/ignore semantics,
  * accumulation into the [T, R, K, A, M] interpolated-precision tensor,
  * ``bbox`` and ``segm``: the standard 12 summary stats extended with
    AR@.5 and the per-area AP@.5 and AR@.5 (stats[12..18]); ``segm``
    matches RLE masks through ``eval/rle.py::iou_matrix``,
  * ``keypoints``: OKS matching with COCO's 17 person sigmas, maxDets
    [20], GT without a labelled keypoint ignored, and the standard 10
    stats (``KPT_STAT_NAMES``).

Where JAX's ``segm`` fails on a GT segmentation given as polygons (it
reads them as an RLE), the port rasterizes them on the image's canvas
first, as pycocotools does (ROADMAP, Queue 3).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from detectinblur_tpu_torch.eval import rle as rle_mod
from detectinblur_tpu_torch.eval.coco_index import COCOIndex

AREA_RNG = [
    [0.0, 1e5**2],
    [0.0, 32.0**2],
    [32.0**2, 96.0**2],
    [96.0**2, 1e5**2],
]
AREA_LBL = ["all", "small", "medium", "large"]

STAT_NAMES = [
    "AP", "AP50", "AP75", "APs", "APm", "APl",
    "AR1", "AR10", "AR100", "ARs", "ARm", "ARl",
    "AR50", "AP50s", "AP50m", "AP50l", "AR50s", "AR50m", "AR50l",
]

# COCO person-keypoint OKS sigmas (pycocotools cocoeval.py Params.setKpParams).
KPT_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89]) / 10.0

KPT_STAT_NAMES = ["AP", "AP50", "AP75", "APm", "APl",
                  "AR", "AR50", "AR75", "ARm", "ARl"]


def bbox_iou_crowd(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU between dt [D, 4] and gt [G, 4] xywh boxes; for crowd gt the
    denominator is the detection area (IoA), per COCO protocol."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix = np.clip(
        np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]), 0, None
    )
    iy = np.clip(
        np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]), 0, None
    )
    inter = ix * iy
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


class COCOEval:
    """Evaluator over a GT index and a results index.

    Usage: evaluate(); accumulate(); summarize(). ``eval_imgs`` entries
    are plain dicts keyed like pycocotools'. The GT index's annotations
    are read, never changed."""

    def __init__(self, coco_gt: COCOIndex, coco_dt: COCOIndex, iou_type: str = "bbox"):
        if iou_type not in ("bbox", "segm", "keypoints"):
            raise ValueError(f"iou_type {iou_type!r}")
        self.coco_gt = coco_gt
        self.coco_dt = coco_dt
        self.iou_type = iou_type
        self.img_ids: List[int] = coco_gt.get_img_ids()
        self.cat_ids: List[int] = coco_gt.get_cat_ids() or [-1]
        self.iou_thrs = np.linspace(0.5, 0.95, 10)
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        self.max_dets = [20] if iou_type == "keypoints" else [1, 10, 100]
        self.kpt_sigmas = KPT_SIGMAS
        self.eval_imgs: Dict = {}
        self.eval: Optional[dict] = None
        self.stats: Optional[np.ndarray] = None
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for a in coco_gt.dataset.get("annotations", []):
            if iou_type == "keypoints":
                # cocoeval._prepare: GT without a labelled keypoint is
                # ignored.
                a = dict(a)
                nk = a.get("num_keypoints")
                if nk is None and "keypoints" in a:
                    nk = int(np.count_nonzero(
                        np.asarray(a["keypoints"])[2::3] > 0))
                a["ignore"] = a.get("ignore", 0) or (nk == 0)
            elif iou_type == "segm" and isinstance(a["segmentation"], list):
                img = coco_gt.imgs[a["image_id"]]
                a = dict(a, segmentation=rle_mod.to_rle(
                    a["segmentation"], img["height"], img["width"]))
            self._gts[(a["image_id"], a["category_id"])].append(a)
        for a in coco_dt.dataset.get("annotations", []):
            self._dts[(a["image_id"], a["category_id"])].append(a)

    # ------------------------------------------------------------ matching
    def _compute_iou(self, img_id, cat_id):
        gts = self._gts[(img_id, cat_id)]
        dts = self._dts[(img_id, cat_id)]
        if not gts or not dts:
            return np.zeros((len(dts), len(gts)))
        order = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts = [dts[i] for i in order][: self.max_dets[-1]]
        iscrowd = np.array([g.get("iscrowd", 0) for g in gts])
        if self.iou_type == "bbox":
            d = np.array([dt["bbox"] for dt in dts], np.float64)
            g = np.array([gt["bbox"] for gt in gts], np.float64)
            return bbox_iou_crowd(d, g, iscrowd)
        if self.iou_type == "segm":
            return rle_mod.iou_matrix([dt["segmentation"] for dt in dts],
                                      [gt["segmentation"] for gt in gts],
                                      iscrowd)
        return self._compute_oks(dts, gts)

    def _compute_oks(self, dts, gts):
        """Object keypoint similarity matrix (cocoeval.py computeOks): per
        labelled GT keypoint, a Gaussian of the position error scaled by
        the keypoint's sigma and the GT's area; a GT with no labelled
        keypoint scores each detected keypoint by its distance outside
        the GT box grown by its size on each side."""
        var = (2.0 * self.kpt_sigmas) ** 2
        k = len(self.kpt_sigmas)
        ious = np.zeros((len(dts), len(gts)))
        for j, gt in enumerate(gts):
            g = np.asarray(gt["keypoints"], np.float64)
            xg, yg, vg = g[0::3], g[1::3], g[2::3]
            k1 = int(np.count_nonzero(vg > 0))
            bb = gt["bbox"]
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            for i, dt in enumerate(dts):
                d = np.asarray(dt["keypoints"], np.float64)
                xd, yd = d[0::3], d[1::3]
                if k1 > 0:
                    dx, dy = xd - xg, yd - yg
                else:
                    z = np.zeros(k)
                    dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                    dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
                e = (dx**2 + dy**2) / var / (gt["area"] + np.spacing(1)) / 2
                if k1 > 0:
                    e = e[vg > 0]
                ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
        return ious

    def evaluate_img(self, img_id, cat_id, area_rng, ious):
        """Greedy per-image matching (COCOeval.evaluateImg semantics)."""
        gts = self._gts[(img_id, cat_id)]
        dts = self._dts[(img_id, cat_id)]
        if not gts and not dts:
            return None
        T = len(self.iou_thrs)
        max_det = self.max_dets[-1]

        g_ignore = np.array(
            [
                1.0
                if (g.get("ignore", 0) or g.get("iscrowd", 0)
                    or g["area"] < area_rng[0] or g["area"] > area_rng[1])
                else 0.0
                for g in gts
            ]
        )
        g_order = np.argsort(g_ignore, kind="mergesort")
        gts_sorted = [gts[i] for i in g_order]
        g_ig = g_ignore[g_order]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gts_sorted]

        d_order = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts_sorted = [dts[i] for i in d_order][:max_det]

        ious_s = ious[:, g_order] if len(ious) else ious

        G, D = len(gts_sorted), len(dts_sorted)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        dt_ig = np.zeros((T, D))
        if D and G:
            for ti, t in enumerate(self.iou_thrs):
                for di in range(D):
                    best_iou = min(t, 1 - 1e-10)
                    m = -1
                    for gi in range(G):
                        if gtm[ti, gi] > 0 and not iscrowd[gi]:
                            continue
                        if m > -1 and g_ig[m] == 0 and g_ig[gi] == 1:
                            break
                        if ious_s[di, gi] < best_iou:
                            continue
                        best_iou = ious_s[di, gi]
                        m = gi
                    if m == -1:
                        continue
                    dt_ig[ti, di] = g_ig[m]
                    dtm[ti, di] = gts_sorted[m]["id"]
                    gtm[ti, m] = dts_sorted[di]["id"]

        # Detections outside the area range that matched nothing -> ignore.
        d_areas = np.array(
            [d.get("area", d["bbox"][2] * d["bbox"][3]) for d in dts_sorted]
        ) if D else np.zeros(0)
        d_out = (d_areas < area_rng[0]) | (d_areas > area_rng[1])
        dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == 0, d_out[None, :]))

        return {
            "image_id": img_id,
            "category_id": cat_id,
            "aRng": area_rng,
            "maxDet": max_det,
            "dtIds": [d["id"] for d in dts_sorted],
            "gtIds": [g["id"] for g in gts_sorted],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dts_sorted],
            "gtIgnore": g_ig,
            "dtIgnore": dt_ig,
        }

    def evaluate(self, img_ids: Optional[Sequence[int]] = None):
        """Run matching for the given images (all by default)."""
        img_ids = list(img_ids) if img_ids is not None else self.img_ids
        for img_id in img_ids:
            for cat_id in self.cat_ids:
                ious = self._compute_iou(img_id, cat_id)
                for a, rng in enumerate(AREA_RNG):
                    self.eval_imgs[(img_id, cat_id, a)] = self.evaluate_img(
                        img_id, cat_id, rng, ious
                    )

    # ---------------------------------------------------------- accumulate
    def accumulate(self, img_ids: Optional[Sequence[int]] = None):
        img_ids = list(img_ids) if img_ids is not None else self.img_ids
        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        K = len(self.cat_ids)
        A = len(AREA_RNG)
        M = len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        for k, cat_id in enumerate(self.cat_ids):
            for a in range(A):
                entries = [
                    self.eval_imgs.get((i, cat_id, a)) for i in img_ids
                ]
                entries = [e for e in entries if e is not None]
                if not entries:
                    continue
                for m, max_det in enumerate(self.max_dets):
                    dt_scores = np.concatenate(
                        [np.asarray(e["dtScores"][:max_det]) for e in entries]
                    )
                    order = np.argsort(-dt_scores, kind="mergesort")
                    dt_scores = dt_scores[order]
                    dtm = np.concatenate(
                        [e["dtMatches"][:, :max_det] for e in entries], axis=1
                    )[:, order]
                    dt_ig = np.concatenate(
                        [e["dtIgnore"][:, :max_det] for e in entries], axis=1
                    )[:, order]
                    gt_ig = np.concatenate([e["gtIgnore"] for e in entries])
                    npig = int(np.count_nonzero(gt_ig == 0))
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm > 0, np.logical_not(dt_ig))
                    fps = np.logical_and(dtm == 0, np.logical_not(dt_ig))
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp = tp_sum[t]
                        fp = fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(fp + tp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0.0

                        # Monotone non-increasing precision envelope.
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, self.rec_thrs, side="left")
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = dt_scores[pi]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss

        self.eval = {"precision": precision, "recall": recall, "scores": scores}
        return self.eval

    # ----------------------------------------------------------- summarize
    def _summary(self, ap: bool, iou_thr=None, area="all", max_dets=100) -> float:
        if self.eval is None:
            raise RuntimeError("run accumulate() first")
        aind = AREA_LBL.index(area)
        mind = self.max_dets.index(max_dets)
        if ap:
            s = self.eval["precision"]
            if iou_thr is not None:
                s = s[np.where(np.isclose(self.iou_thrs, iou_thr))[0]]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                s = s[np.where(np.isclose(self.iou_thrs, iou_thr))[0]]
            s = s[:, :, aind, mind]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self) -> np.ndarray:
        """The repo's 19-stat summary: the standard 12 stats, AR@.5, then
        per-area AP@.5 and AR@.5 (``STAT_NAMES``); for keypoints the
        standard 10 stats at maxDets 20 (``KPT_STAT_NAMES``)."""
        s = self._summary
        md = self.max_dets
        if self.iou_type == "keypoints":
            m = md[-1]
            self.stats = np.array([
                s(True, max_dets=m),
                s(True, 0.5, max_dets=m),
                s(True, 0.75, max_dets=m),
                s(True, area="medium", max_dets=m),
                s(True, area="large", max_dets=m),
                s(False, max_dets=m),
                s(False, 0.5, max_dets=m),
                s(False, 0.75, max_dets=m),
                s(False, area="medium", max_dets=m),
                s(False, area="large", max_dets=m),
            ])
            return self.stats
        self.stats = np.array(
            [
                s(True),
                s(True, 0.5, max_dets=md[2]),
                s(True, 0.75, max_dets=md[2]),
                s(True, area="small", max_dets=md[2]),
                s(True, area="medium", max_dets=md[2]),
                s(True, area="large", max_dets=md[2]),
                s(False, max_dets=md[0]),
                s(False, max_dets=md[1]),
                s(False, max_dets=md[2]),
                s(False, area="small", max_dets=md[2]),
                s(False, area="medium", max_dets=md[2]),
                s(False, area="large", max_dets=md[2]),
                s(False, 0.5, max_dets=md[2]),
                s(True, 0.5, area="small", max_dets=md[2]),
                s(True, 0.5, area="medium", max_dets=md[2]),
                s(True, 0.5, area="large", max_dets=md[2]),
                s(False, 0.5, area="small", max_dets=md[2]),
                s(False, 0.5, area="medium", max_dets=md[2]),
                s(False, 0.5, area="large", max_dets=md[2]),
            ]
        )
        return self.stats

    def print_summary(self):
        if self.stats is None:
            raise RuntimeError("run summarize() first")
        tmpl = (" Average {:9} ({}) @[ IoU={:9} | area={:>6} | maxDets={:>3} ]"
                " = {:0.3f}")
        rows = [
            ("Precision", "AP", "0.50:0.95", "all", 100, self.stats[0]),
            ("Precision", "AP", "0.50", "all", 100, self.stats[1]),
            ("Precision", "AP", "0.75", "all", 100, self.stats[2]),
            ("Precision", "AP", "0.50:0.95", "small", 100, self.stats[3]),
            ("Precision", "AP", "0.50:0.95", "medium", 100, self.stats[4]),
            ("Precision", "AP", "0.50:0.95", "large", 100, self.stats[5]),
            ("Recall", "AR", "0.50:0.95", "all", 1, self.stats[6]),
            ("Recall", "AR", "0.50:0.95", "all", 10, self.stats[7]),
            ("Recall", "AR", "0.50:0.95", "all", 100, self.stats[8]),
            ("Recall", "AR", "0.50:0.95", "small", 100, self.stats[9]),
            ("Recall", "AR", "0.50:0.95", "medium", 100, self.stats[10]),
            ("Recall", "AR", "0.50:0.95", "large", 100, self.stats[11]),
        ]
        for r in rows:
            print(tmpl.format(*r))
