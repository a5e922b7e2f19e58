"""Exact greedy NMS over padded tensors (port of ``detectinblur_tpu/ops/nms.py``).

Plain torch, no kernel: NMS was plain XLA in the JAX package. Results match
it exactly: the same keep set, the same order, the same padding and
``valid`` masks, with ties broken by the lowest index (a stable descending
sort stands in for ``jax.lax.top_k``, whose tie-break ``torch.topk`` does
not promise).

Every function takes leading batch dimensions, so a batch of images (or of
images x pyramid levels) runs as one set of tensor ops.

Host syncs: the within-block fixpoint (see ``_alive_sorted``) checks for
convergence once every ``_FIXPOINT_CHUNK`` vectorised steps, bounded at the
block size; everything else is sync-free.
"""

from __future__ import annotations

import torch

from detectinblur_tpu_torch.ops.boxes import box_iou

NEG_INF = -1e30

_BLOCK = 128
_FIXPOINT_CHUNK = 4


def _killed(alive: torch.Tensor, sup: torch.Tensor) -> torch.Tensor:
    """[M, n] alive x [M, n, m] suppression -> [M, m]: suppressed by any
    alive row."""
    return (alive[:, :, None] & sup).any(dim=1)


def _alive_sorted(sboxes: torch.Tensor, salive: torch.Tensor,
                  thr: float) -> torch.Tensor:
    """Greedy-NMS aliveness over score-DESCENDING boxes, batched.

    ``sboxes`` [M, N, 4], ``salive`` [M, N] bool; among alive entries the
    scores are non-increasing (dead entries may sit anywhere). Blocked as
    the JAX version: within a block of 128, the rank-masked suppression
    operator is iterated to its unique fixpoint (the greedy answer; rank k
    is exact after k steps, so the block size bounds the loop), then the
    block's survivors suppress every later box in one vectorised pass.
    """
    M, N = salive.shape
    n_blocks = (N + _BLOCK - 1) // _BLOCK
    pad = n_blocks * _BLOCK - N
    sboxes = sboxes.float()
    if pad:
        sboxes = torch.cat([sboxes, sboxes.new_zeros(M, pad, 4)], dim=1)
        salive = torch.cat([salive, salive.new_zeros(M, pad)], dim=1)
    alive = salive.clone()
    ar = torch.arange(_BLOCK, device=salive.device)
    tri = ar[:, None] < ar[None, :]

    for i in range(n_blocks):
        lo, hi = i * _BLOCK, (i + 1) * _BLOCK
        blk = sboxes[:, lo:hi]
        blk_alive = alive[:, lo:hi]
        sup = (box_iou(blk, blk) > thr) & tri     # [M, r, c]: r kills c, r<c

        prev = blk_alive
        cur = blk_alive & ~_killed(prev, sup)
        for _ in range(0, _BLOCK, _FIXPOINT_CHUNK):
            if not bool((cur != prev).any()):
                break
            for _ in range(_FIXPOINT_CHUNK):
                prev, cur = cur, blk_alive & ~_killed(cur, sup)

        # Survivors of this block suppress every later box.
        if hi < alive.shape[1]:
            cross = _killed(cur, box_iou(blk, sboxes[:, hi:]) > thr)
            alive[:, hi:] &= ~cross
        alive[:, lo:hi] = cur
    return alive[:, :N]


def _select_top(key: torch.Tensor, alive: torch.Tensor, max_outputs: int):
    """The ``max_outputs`` largest ``key`` entries, ties to the lowest
    index (``jax.lax.top_k`` order). Returns (idxs, valid) with idxs = 0
    on invalid slots, padded to ``max_outputs``."""
    n = key.shape[-1]
    k = min(max_outputs, n)
    picked = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    valid = torch.gather(alive, -1, picked)
    idxs = torch.where(valid, picked, torch.zeros_like(picked)).int()
    if k < max_outputs:
        fill = (*idxs.shape[:-1], max_outputs - k)
        idxs = torch.cat([idxs, idxs.new_zeros(fill)], dim=-1)
        valid = torch.cat([valid, valid.new_zeros(fill)], dim=-1)
    return idxs, valid


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_outputs: int):
    """Exact greedy NMS.

    Args:
      boxes: [..., N, 4] xyxy.
      scores: [..., N]; invalid entries = NEG_INF (padding idiom).
      iou_threshold: suppress boxes with IoU strictly greater than this.
      max_outputs: number of output slots.

    Returns (indices [..., max_outputs] int32, valid [..., max_outputs]
    bool), selections in descending score order.
    """
    lead = scores.shape[:-1]
    N = scores.shape[-1]
    scores = scores.reshape(-1, N).float()
    boxes = boxes.reshape(-1, N, 4)
    order = torch.sort(-scores, dim=-1, stable=True)[1]
    sboxes = torch.gather(boxes.float(), 1, order[..., None].expand(-1, -1, 4))
    salive = torch.gather(scores, 1, order) > NEG_INF
    alive = _alive_sorted(sboxes, salive, iou_threshold)
    # Rank epilogue: the best survivors in sorted-rank order.
    rank = torch.arange(N, device=scores.device, dtype=torch.float32)
    key = torch.where(alive, -rank, torch.full_like(rank, -float("inf")))
    picked, valid = _select_top(key, alive, max_outputs)
    idxs = torch.where(valid, torch.gather(order, 1, picked.long()),
                       torch.zeros_like(order[:, :1])).int()
    return idxs.reshape(*lead, max_outputs), valid.reshape(*lead, max_outputs)


def grouped_nms_presorted(boxes: torch.Tensor, scores: torch.Tensor,
                          iou_threshold: float, max_outputs: int):
    """Exact category-aware NMS over pre-grouped, pre-sorted candidates.

    ``boxes`` [..., G, K, 4], ``scores`` [..., G, K]: within each group the
    alive entries (scores > NEG_INF) are score-descending. Groups never
    suppress each other. The selection is the global best ``max_outputs``
    survivors by score, ties to the lowest flattened (group-major) index,
    which equals ``batched_nms`` over the flattened arrays.

    Returns (indices into the flattened [..., G*K] arrays, valid).
    """
    lead = scores.shape[:-2]
    G, K = scores.shape[-2:]
    flat_scores = scores.reshape(-1, G * K).float()
    alive = _alive_sorted(boxes.reshape(-1, K, 4),
                          (scores > NEG_INF).reshape(-1, K), iou_threshold)
    alive = alive.reshape(-1, G * K)
    key = torch.where(alive, flat_scores,
                      torch.full_like(flat_scores, -float("inf")))
    idxs, valid = _select_top(key, alive, max_outputs)
    return idxs.reshape(*lead, max_outputs), valid.reshape(*lead, max_outputs)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                categories: torch.Tensor, iou_threshold: float,
                max_outputs: int):
    """Category-aware NMS via the coordinate-offset trick (torchvision
    batched_nms): boxes of different categories never overlap. Leading
    dimensions are independent problems, each with its own offset."""
    live = scores > NEG_INF
    max_coord = torch.where(live, boxes.max(dim=-1).values,
                            torch.zeros_like(scores)).amax(dim=-1, keepdim=True)
    offsets = categories.float() * (max_coord + 1.0)
    return nms(boxes + offsets[..., None], scores, iou_threshold, max_outputs)
