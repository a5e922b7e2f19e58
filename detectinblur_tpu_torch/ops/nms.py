"""Exact greedy NMS over padded tensors (port of ``detectinblur_tpu/ops/nms.py``).

Results match the JAX package exactly: the same keep set, the same order,
the same padding and ``valid`` masks, with ties broken by the lowest index
(a stable descending sort stands in for ``jax.lax.top_k``, whose tie-break
``torch.topk`` does not promise).

Every function takes leading batch dimensions, so a batch of images (or of
images x pyramid levels) runs as one set of tensor ops.

The greedy pass (``_alive_sorted``, JAX's ``lax.scan`` of blocked
fixpoints) is the two kernels of ``csrc/nms.cu`` for CUDA tensors,
through ``nms_alive``, which launches them on the current stream and
reads nothing back, so NMS on the card never waits on the host. For CPU
tensors it is the plain blocked version ``_alive_sorted_plain``, which
checks each block's fixpoint for convergence on the host once every
``_FIXPOINT_CHUNK`` vectorised steps. The sorts and the rank epilogue are
torch ops on either device, as JAX left them to XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from detectinblur_tpu_torch.ops.boxes import box_iou
from detectinblur_tpu_torch.utils import cuda_build
from detectinblur_tpu_torch.utils.profiling import counts_launches, span

NEG_INF = -1e30

_BLOCK = 128
_FIXPOINT_CHUNK = 4
_WORD = 64          # boxes per word of the kernel's suppression bitmask
_PLAIN_ROWS = 512   # rows of the plain suppression mask made at a time


def _killed(alive: torch.Tensor, sup: torch.Tensor) -> torch.Tensor:
    """[M, n] alive x [M, n, m] suppression -> [M, m]: suppressed by any
    alive row."""
    return (alive[:, :, None] & sup).any(dim=1)


def _alive_sorted_plain(sboxes: torch.Tensor, salive: torch.Tensor,
                        thr: float) -> torch.Tensor:
    """Greedy-NMS aliveness over score-DESCENDING boxes, batched: the plain
    torch version of ``csrc/nms.cu``.

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


@functools.lru_cache(maxsize=None)
def _library():
    """``csrc/nms.cu`` built and loaded: ``nms_alive`` (both kernels),
    ``nms_mask`` and ``nms_scan`` (one each, for timing them apart), all
    ``(boxes, alive_in, alive_out, mask, M, N, stride, thr, stream) ->
    CUDA error``."""
    lib = cuda_build.load("nms")
    for name in ("nms_alive", "nms_mask", "nms_scan"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def mask_stride(n: int) -> int:
    """Row stride, in 64-bit words, of the kernel's suppression bitmask:
    ceil(n/64) rounded up to even, so that every row starts 16-byte
    aligned for the scan's bulk copies."""
    words = -(-n // _WORD)
    return words + words % 2


def _covered_words(salive: torch.Tensor) -> torch.Tensor:
    """[M, N, ``mask_stride(N)``] bool: the words of the suppression
    bitmask that the mask kernel must write, column words cw >= r // 64
    (up to ceil(N/64)) of every alive row r. The scan reads no other word
    into its result (the note of ``csrc/nms.cu``)."""
    N = salive.shape[1]
    cw = torch.arange(mask_stride(N), device=salive.device)
    rw = torch.arange(N, device=salive.device) // _WORD
    span = (cw[None, :] >= rw[:, None]) & (cw[None, :] < -(-N // _WORD))
    return salive[:, :, None] & span


def _suppression_mask_plain(sboxes: torch.Tensor, salive: torch.Tensor,
                            thr: float) -> torch.Tensor:
    """The plain version of ``csrc/nms.cu``'s mask kernel: int64 [M, N,
    ``mask_stride(N)``] words from ``box_iou``, bit j of word cw of row r
    set when c = 64 cw + j > r, c is alive and IoU(r, c) > thr, on the
    words ``_covered_words`` names; every other word is 0. Only the tests
    and ``chip_smoke.py`` call it."""
    M, N = salive.shape
    words = -(-N // _WORD)
    dev = salive.device
    b = sboxes.float()
    idx = torch.arange(N, device=dev)
    # Bit 63 weighs -2**63: the sum is the word's two's complement.
    weight = torch.tensor([1 << j for j in range(_WORD - 1)]
                          + [-(1 << (_WORD - 1))], device=dev)
    out = torch.zeros(M, N, mask_stride(N), dtype=torch.int64, device=dev)
    for lo in range(0, N, _PLAIN_ROWS):
        hi = min(lo + _PLAIN_ROWS, N)
        sup = ((box_iou(b[:, lo:hi], b) > thr) & salive[:, None, :]
               & (idx[lo:hi, None] < idx[None, :]))
        sup = torch.cat([sup, sup.new_zeros(M, hi - lo, words * _WORD - N)],
                        dim=-1)
        out[:, lo:hi, :words] = (sup.view(M, hi - lo, words, _WORD).long()
                                 * weight).sum(-1)
    return out.masked_fill_(~_covered_words(salive), 0)


def kernel_args(sboxes: torch.Tensor, salive: torch.Tensor, thr: float):
    """(alive out, the scratch bitmask, the C entry points' arguments) for
    inputs that ``nms_alive`` has checked, on the current stream."""
    M, N = salive.shape
    stride = mask_stride(N)
    alive = torch.empty_like(salive)
    mask = torch.empty(M, N, stride, dtype=torch.int64, device=sboxes.device)
    return alive, mask, (sboxes.data_ptr(), salive.data_ptr(),
                         alive.data_ptr(), mask.data_ptr(), M, N, stride,
                         float(thr), torch.cuda.current_stream().cuda_stream)


@counts_launches
def nms_alive(sboxes: torch.Tensor, salive: torch.Tensor,
              thr: float) -> torch.Tensor:
    """The greedy pass of ``_alive_sorted``: ``sboxes`` [M, N, 4] float32
    and ``salive`` [M, N] bool, contiguous, on one device -> the alive
    mask [M, N]. For CUDA tensors, the kernels of ``csrc/nms.cu`` (the
    pairwise suppression words of the alive rows in an [M, N,
    ``mask_stride(N)``] int64 scratch, ``_suppression_mask_plain``'s on
    the words ``_covered_words`` names, then one block per problem walking
    them in rank order, its row blocks staged in shared memory); for
    tensors on the CPU, ``_alive_sorted_plain``."""
    if sboxes.device.type == "cpu":
        return _alive_sorted_plain(sboxes, salive, thr)
    if sboxes.device.type != "cuda":
        raise ValueError(f"unsupported device {sboxes.device}")
    if sboxes.dtype != torch.float32 or salive.dtype != torch.bool:
        raise TypeError(f"nms_alive takes float32 boxes and a bool mask, got "
                        f"{sboxes.dtype} and {salive.dtype}")
    if salive.device != sboxes.device:
        raise ValueError(f"boxes on {sboxes.device} but the mask on "
                         f"{salive.device}")
    if (sboxes.ndim != 3 or sboxes.shape[-1] != 4
            or salive.shape != sboxes.shape[:2]):
        raise ValueError(f"expected boxes [M, N, 4] and a mask [M, N], got "
                         f"{tuple(sboxes.shape)} and {tuple(salive.shape)}")
    if not (sboxes.is_contiguous() and salive.is_contiguous()) \
            or sboxes.data_ptr() % 16:
        raise ValueError("boxes and mask must be contiguous, the boxes "
                         "16-byte aligned")
    M, N = salive.shape
    if M == 0 or N == 0:
        return salive.clone()
    with torch.cuda.device(sboxes.device):
        alive, _, args = kernel_args(sboxes, salive, thr)
        err = _library().nms_alive(*args)
    if err:
        raise RuntimeError(f"nms_alive kernel launch failed: CUDA error {err}"
                           " (1: N beyond the scan's shared memory)")
    nms_alive.launches += 1
    return alive


def _alive_sorted(sboxes: torch.Tensor, salive: torch.Tensor,
                  thr: float) -> torch.Tensor:
    """Greedy-NMS aliveness over score-DESCENDING boxes [M, N, 4] (cast to
    float32, as JAX does), batched: the kernel for CUDA tensors, the plain
    blocked version for CPU ones (``nms_alive``)."""
    return nms_alive(sboxes.float().contiguous(), salive.contiguous(), thr)


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
    with span("nms"):
        lead = scores.shape[:-1]
        N = scores.shape[-1]
        scores = scores.reshape(-1, N).float()
        boxes = boxes.reshape(-1, N, 4)
        order = torch.sort(-scores, dim=-1, stable=True)[1]
        sboxes = torch.gather(boxes.float(), 1,
                              order[..., None].expand(-1, -1, 4))
        salive = torch.gather(scores, 1, order) > NEG_INF
        alive = _alive_sorted(sboxes, salive, iou_threshold)
        # Rank epilogue: the best survivors in sorted-rank order.
        rank = torch.arange(N, device=scores.device, dtype=torch.float32)
        key = torch.where(alive, -rank,
                          torch.full_like(rank, -float("inf")))
        picked, valid = _select_top(key, alive, max_outputs)
        idxs = torch.where(valid, torch.gather(order, 1, picked.long()),
                           torch.zeros_like(order[:, :1])).int()
        return (idxs.reshape(*lead, max_outputs),
                valid.reshape(*lead, max_outputs))


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
    with span("nms"):
        lead = scores.shape[:-2]
        G, K = scores.shape[-2:]
        flat_scores = scores.reshape(-1, G * K).float()
        alive = _alive_sorted(boxes.reshape(-1, K, 4),
                              (scores > NEG_INF).reshape(-1, K),
                              iou_threshold)
        alive = alive.reshape(-1, G * K)
        key = torch.where(alive, flat_scores,
                          torch.full_like(flat_scores, -float("inf")))
        idxs, valid = _select_top(key, alive, max_outputs)
        return (idxs.reshape(*lead, max_outputs),
                valid.reshape(*lead, max_outputs))


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                categories: torch.Tensor, iou_threshold: float,
                max_outputs: int):
    """Category-aware NMS via the coordinate-offset trick (torchvision
    batched_nms): boxes of different categories never overlap. Leading
    dimensions are independent problems, each with its own offset."""
    with span("nms"):
        live = scores > NEG_INF
        max_coord = torch.where(live, boxes.max(dim=-1).values,
                                torch.zeros_like(scores)).amax(
                                    dim=-1, keepdim=True)
        offsets = categories.float() * (max_coord + 1.0)
        return nms(boxes + offsets[..., None], scores, iou_threshold,
                   max_outputs)
