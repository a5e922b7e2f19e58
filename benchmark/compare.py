"""The numbers that decide ``correct``: what the timed path produced,
held against the plain reference on the same inputs.

Detections: per frame, the reference's detections and the program's are
matched greedily, best reference score first, each to the unmatched
program detection of its label with the highest IoU at or above
``IOU_MATCH``. The frame's mismatch is the score mass that does not
agree: the scores of unmatched detections on both sides plus the score
gap of each matched pair, over both sides' total score. 0 is the same
detections with the same scores; 1 is no detection in common.

Training: by the worst leaf, the gap between the program's norm of a
tensor and the reference's, against the larger of the reference's norm of
that leaf and of the median leaf.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

IOU_MATCH = 0.5


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-12)


def frame_mismatch(p_boxes, p_scores, p_labels, r_boxes, r_scores,
                   r_labels) -> float:
    """The score-weighted mismatch of one frame's valid detections."""
    total = float(p_scores.sum() + r_scores.sum())
    if total == 0.0:
        return 0.0
    iou = _iou(r_boxes, p_boxes) if len(r_boxes) and len(p_boxes) else \
        np.zeros((len(r_boxes), len(p_boxes)))
    iou = np.where(r_labels[:, None] == p_labels[None, :], iou, -1.0)
    used = np.zeros(len(p_boxes), bool)
    bad = 0.0
    for i in np.argsort(-r_scores, kind="stable"):
        cand = np.where(used, -1.0, iou[i])
        j = int(np.argmax(cand)) if len(cand) else -1
        if j >= 0 and cand[j] >= IOU_MATCH:
            used[j] = True
            bad += abs(float(r_scores[i]) - float(p_scores[j]))
        else:
            bad += float(r_scores[i])
    bad += float(p_scores[~used].sum())
    return bad / total


def detections_mismatch(program, reference) -> np.ndarray:
    """Per-frame mismatch of two (boxes, scores, labels, valid) batches."""
    pb, ps, pl, pv = (np.asarray(t) for t in program)
    rb, rs, rl, rv = (np.asarray(t) for t in reference)
    out = []
    for f in range(pb.shape[0]):
        pm, rm = pv[f].astype(bool), rv[f].astype(bool)
        out.append(frame_mismatch(pb[f][pm].astype(np.float64),
                                  ps[f][pm].astype(np.float64), pl[f][pm],
                                  rb[f][rm].astype(np.float64),
                                  rs[f][rm].astype(np.float64), rl[f][rm]))
    return np.asarray(out)


def detect_numbers(frames: Sequence[float]) -> Dict[str, float]:
    """Every number a detection cell can compare, from the per-frame
    mismatches; the cell's limits file says which are compared."""
    return {"det_mismatch": float(np.max(frames)),
            "det_mismatch_mean": float(np.mean(frames))}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              leaves: Sequence[str]) -> np.ndarray:
    """Per leaf of ``leaves``: |program - reference| / max(reference, the
    median leaf's reference norm); a leaf the program lacks reads 1."""
    median = float(np.median([reference[k] for k in reference]))
    out = []
    for k in leaves:
        den = max(reference[k], median)
        out.append(1.0 if k not in program else
                   abs(program[k] - reference[k]) / den if den > 0 else 0.0)
    return np.asarray(out)


def worst_leaf_gap(program, reference, leaves) -> float:
    gaps = leaf_gaps(program, reference, leaves)
    return float(gaps.max()) if len(gaps) else 0.0


def worst_leaves(program, reference, leaves, n: int = 3):
    """[[leaf, gap, program norm, reference norm]] of the ``n`` worst."""
    gaps = leaf_gaps(program, reference, leaves)
    order = np.argsort(-gaps)[:n]
    return [[leaves[i], float(gaps[i]), program.get(leaves[i]),
             reference[leaves[i]]] for i in order]


RPN_TERMS = ("loss_objectness", "loss_rpn_box_reg")
HEAD_TERMS = ("loss_classifier", "loss_box_reg")


def _rel(p: float, r: float) -> float:
    return abs(p - r) / abs(r) if r else abs(p)


def train_numbers(losses, grad, change, ref_losses, ref_grad,
                  ref_change) -> Dict[str, float]:
    """Every number a training cell can compare, from the program's and
    the reference's per-step losses ({term: value}) and the leaf norms of
    the first gradients and of the changes after the steps. Leaves whose
    reference gradient is nought to rounding (``moved_leaves``) are left
    out of the gradient and change numbers. The cell's limits file says
    which numbers are compared."""
    moved = moved_leaves(ref_grad)
    rpn_head = [k for k in moved if k.startswith("rpn_head.")]

    def loss(terms, steps):
        return max(_rel(sum(p[t] for t in terms), sum(r[t] for t in terms))
                   for p, r in list(zip(losses, ref_losses))[:steps])

    every = tuple(ref_losses[0])
    n = len(ref_losses)
    out = {"loss_gap": loss(every, n), "loss_gap_1": loss(every, 1),
           "rpn_loss_gap": loss(RPN_TERMS, n),
           "rpn_loss_gap_1": loss(RPN_TERMS, 1),
           "head_loss_gap": loss(HEAD_TERMS, n),
           "grad_gap": worst_leaf_gap(grad, ref_grad, moved),
           "rpn_grad_gap": worst_leaf_gap(grad, ref_grad, rpn_head),
           "update_gap": worst_leaf_gap(change, ref_change, moved),
           "grad_gap_median": float(np.median(
               leaf_gaps(grad, ref_grad, moved))),
           "update_gap_median": float(np.median(
               leaf_gaps(change, ref_change, moved)))}
    if set(grad) - set(ref_grad):
        # a leaf the program trains and the reference does not
        out["update_gap"] = max(out["update_gap"], 1.0)
    return out


def moved_leaves(ref_grad: Dict[str, float], share: float = 1e-3):
    """The leaves whose reference gradient norm reaches ``share`` of the
    median leaf's: below it the gradient is nought to rounding and a leaf
    moves by round-off and weight decay alone (a BatchNorm bias whose
    channels feed only another batch-statistics BatchNorm, which removes
    any shift)."""
    median = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= share * median]
