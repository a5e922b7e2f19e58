"""Hard inputs for exact greedy NMS, made from a seed with numpy only.

``tests/test_torch_port_nms.py`` holds the port's NMS against JAX's on
them (CPU), ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` the
kernel against its plain version (card). Each case is a dict: ``name``,
``boxes`` [N, 4] float32 xyxy, ``scores`` [N] float32 (``NEG_INF`` marks a
dead entry), ``thr``, ``categories`` [N] int32 or None, and ``expect``:
the keep list in selection order where it is known by construction, else
None.
"""

import numpy as np

NEG_INF = np.float32(-1e30)
SIZES = (1, 63, 64, 65, 127, 129, 4097)


def clustered_boxes(rng, n, canvas=400.0, clusters=12, jitter=6.0):
    """``n`` boxes jittered around a few centres, so that most overlap
    something above the usual thresholds and suppression chains form."""
    centre = rng.uniform(0, canvas, (clusters, 2)).astype(np.float32)
    size = rng.uniform(10, 60, (clusters, 2)).astype(np.float32)
    k = rng.integers(0, clusters, n)
    xy = centre[k] + rng.normal(0, jitter, (n, 2)).astype(np.float32)
    wh = size[k] * rng.uniform(0.7, 1.3, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _far(n, start=1000.0):
    """``n`` unit boxes that overlap nothing, spaced along a row."""
    x = start + 4.0 * np.arange(n, dtype=np.float32)
    return np.stack([x, np.zeros_like(x), x + 1, np.ones_like(x)], axis=1)


def _chain(a_rank, b_rank, c_rank, n):
    """A kills B (IoU 2/3 > 0.5) and B would kill C (2/3), but A and C
    overlap less (3/7), so C survives: greedy keeps A and C. The three sit
    at the given ranks among ``n`` boxes, the rest far apart."""
    boxes = _far(n)
    boxes[a_rank] = [0, 0, 10, 10]
    boxes[b_rank] = [2, 0, 12, 10]
    boxes[c_rank] = [4, 0, 14, 10]
    scores = np.linspace(1.0, 0.01, n, dtype=np.float32)
    return boxes, scores


def cases(seed=0):
    rng = np.random.default_rng(seed)
    out = []

    def add(name, boxes, scores, thr, categories=None, expect=None):
        out.append(dict(name=name, boxes=np.asarray(boxes, np.float32),
                        scores=np.asarray(scores, np.float32), thr=thr,
                        categories=categories, expect=expect))

    # IoU 70/100 rounds to float32(0.7) exactly: not strictly greater, so
    # both stay. At 0.3 the pair's float32 IoU exceeds the double 0.3, so
    # a comparison in double would suppress.
    add("iou_equals_thr_0.7", [[0, 0, 10, 10], [0, 0, 10, 7]], [0.9, 0.8],
        0.7, expect=[0, 1])
    add("iou_equals_thr_0.3", [[0, 0, 10, 10], [0, 0, 10, 3]], [0.9, 0.8],
        0.3, expect=[0, 1])
    # Identical boxes with equal scores: the lowest index survives.
    same = np.concatenate([np.tile([[5, 5, 25, 25]], (5, 1)), _far(3)])
    add("identical_equal_scores", same, [0.5] * 5 + [0.4, 0.3, 0.2], 0.5,
        expect=[0, 5, 6, 7])
    # Zero-area boxes: IoU 0 / max(0, 1e-12) = 0, so none is suppressed,
    # not even a copy of itself or one inside a real box.
    zero = [[3, 3, 3, 9], [3, 3, 3, 9], [0, 4, 8, 4], [2, 2, 2, 2],
            [0, 0, 10, 10], [5, 5, 5, 5]]
    add("zero_area", zero, [0.9, 0.8, 0.7, 0.6, 0.5, 0.4], 0.5,
        expect=[0, 1, 2, 3, 4, 5])
    add("all_dead", clustered_boxes(rng, 50), np.full(50, NEG_INF), 0.5,
        expect=[])
    for n in SIZES:
        s = rng.random(n).astype(np.float32)
        s[rng.random(n) < 0.1] = NEG_INF
        s[1::17] = s[0]          # ties across the array
        add(f"clustered_n{n}", clustered_boxes(rng, n), s, 0.5)
    add("chain_across_64", *_chain(60, 70, 140, 200), 0.5)
    add("chain_at_64_and_128", *_chain(63, 64, 128, 200), 0.5)
    # Every box kept at the postprocess's 4096: nothing overlaps, so every
    # row of every word is ORed into every later word (the kernel's most
    # OR work).
    n = 4096
    add("all_kept_n4096", _far(n), np.linspace(1.0, 0.01, n,
                                               dtype=np.float32), 0.5,
        expect=list(range(n)))
    # One box that suppresses all the rest: the others are jittered copies
    # of it (IoU > 0.6) across 16 words, every one scored below it.
    n = 1000
    boxes = np.tile(np.float32([[100, 100, 200, 200]]), (n, 1))
    boxes[1:] += rng.uniform(-5, 5, (n - 1, 4)).astype(np.float32)
    s = rng.uniform(0.1, 0.9, n).astype(np.float32)
    s[0] = 0.95
    add("one_suppresses_all", boxes, s, 0.5, expect=[0])
    # 5 words, an odd count: the kernel pads its bitmask rows to 6.
    add("odd_words_n320", clustered_boxes(rng, 320), rng.random(320).astype(
        np.float32), 0.5)
    # The postprocess's pool: 4096 candidates over 90 categories on a
    # 1333-pixel canvas, shifted by category * (max coordinate + 1), so
    # the offsets reach ~1.2e5 and float32 rounds the shifted boxes.
    n = 4096
    b = clustered_boxes(rng, n, canvas=1233.0, clusters=40, jitter=10.0)
    s = rng.random(n).astype(np.float32)
    s[rng.random(n) < 0.3] = NEG_INF
    add("categories_90_canvas_1333", b, s, 0.5,
        categories=rng.integers(1, 91, n).astype(np.int32))
    return out


def streamed_case(seed=1, n=16385):
    """A card-only case (the CPU parity tests would be slow on it): at
    16385 boxes a row block of the kernel's bitmask (257 words a row) is
    wider than a staged tile, so the scan streams each in column tiles.
    Clustered at threshold 0.5, 10% of the entries dead."""
    rng = np.random.default_rng(seed)
    s = rng.random(n).astype(np.float32)
    s[rng.random(n) < 0.1] = NEG_INF
    return dict(name=f"streamed_n{n}",
                boxes=clustered_boxes(rng, n, canvas=4000.0, clusters=200),
                scores=s, thr=0.5, categories=None, expect=None)


def expected_chain(case):
    """The keep list of a ``_chain`` case: every box but B."""
    keep = np.argsort(-case["scores"], kind="stable")
    b = np.flatnonzero((case["boxes"] == [2, 0, 12, 10]).all(axis=1))[0]
    return [int(i) for i in keep if i != b]


def sorted_problem(case):
    """(boxes sorted by descending score, stable; alive mask) of a case,
    the inputs of ``_alive_sorted``."""
    order = np.argsort(-case["scores"], kind="stable")
    return case["boxes"][order], case["scores"][order] > NEG_INF
