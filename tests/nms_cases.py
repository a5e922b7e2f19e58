"""Hard inputs for exact greedy NMS, made from a seed with numpy only.

``tests/test_torch_port_nms.py`` holds the port's NMS against JAX's on
them (CPU), ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` the
kernel against its plain version (card). Each case is a dict: ``name``,
``boxes`` [N, 4] float32 xyxy, ``scores`` [N] float32 (``NEG_INF`` marks a
dead entry), ``thr``, ``categories`` [N] int32 or None, ``expect``: the
keep list in selection order where it is known by construction, else
None, and ``presorted``: True where the scores of the alive entries
already descend and the dead ones sit among them, as the RPN's min-size
filter leaves them (``sorted_problem`` keeps that order).
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


def iou_f32(a, b):
    """IoU of two xyxy boxes in float32, in ``box_iou``'s order of
    operations."""
    a, b = np.float32(a), np.float32(b)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    wh = np.maximum(np.minimum(a[2:], b[2:]) - np.maximum(a[:2], b[:2]),
                    np.float32(0))
    inter = wh[0] * wh[1]
    return inter / np.maximum(area_a + area_b - inter, np.float32(1e-12))


def _ulp_pairs(thr, height):
    """Three pairs, 100 apart along x, whose float32 IoUs are one ulp
    below ``thr``, equal to it, and one ulp above: A = [0, 0, 10,
    height], B = A cut to a height near thr * height (IoU = B's height /
    A's, rounded). Scores descend A, B, A, B, A, B: greedy keeps all but
    the last B."""
    t = np.float32(thr)
    h = np.float32(thr * height)
    boxes = []
    for k, (cut, want) in enumerate((
            (np.nextafter(h, np.float32(0)), np.nextafter(t, np.float32(0))),
            (h, t), (np.nextafter(h, np.float32(2 * height)),
                     np.nextafter(t, np.float32(1))))):
        a = np.float32([100 * k, 0, 100 * k + 10, height])
        b = np.float32([100 * k, 0, 100 * k + 10, cut])
        assert iou_f32(a, b) == want, (thr, k, iou_f32(a, b), want)
        boxes += [a, b]
    return np.stack(boxes), np.linspace(0.9, 0.4, 6, dtype=np.float32)


def _sparse(rng, n, alive_frac, presorted):
    """Clustered boxes with ``alive_frac`` of the entries alive: scores
    that descend with dead entries among them (``presorted``), or random
    ones (sorting puts the dead last, as ``nms()`` does)."""
    dead = rng.random(n) >= alive_frac
    s = (np.linspace(1.0, 0.01, n, dtype=np.float32) if presorted
         else rng.random(n).astype(np.float32))
    s[dead] = NEG_INF
    return clustered_boxes(rng, n), s


def cases(seed=0):
    rng = np.random.default_rng(seed)
    out = []

    def add(name, boxes, scores, thr, categories=None, expect=None,
            presorted=False):
        out.append(dict(name=name, boxes=np.asarray(boxes, np.float32),
                        scores=np.asarray(scores, np.float32), thr=thr,
                        categories=categories, expect=expect,
                        presorted=presorted))

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
    # Float32 IoUs one ulp below, at and one ulp above each threshold of
    # the paths: only the last suppresses.
    add("iou_ulp_around_thr_0.5", *_ulp_pairs(0.5, 10), 0.5,
        expect=[0, 1, 2, 3, 4])
    add("iou_ulp_around_thr_0.7", *_ulp_pairs(0.7, 1000), 0.7,
        expect=[0, 1, 2, 3, 4])
    # Few alive among 4097, as a prefix after the sort and scattered in
    # place: the mask kernel skips dead row and column words.
    for frac in (0.01, 0.1):
        for presorted in (False, True):
            add(f"alive_{frac:g}_{'scattered' if presorted else 'prefix'}"
                "_n4097", *_sparse(rng, 4097, frac, presorted), 0.5,
                presorted=presorted)
    # Alive words 0, 1, 5 and 10 of 11, every entry of the words between
    # dead: the survivors of words 0 and 1 suppress across them.
    n = 704
    b = clustered_boxes(rng, n, clusters=4)
    s = np.linspace(1.0, 0.01, n, dtype=np.float32)
    word = np.arange(n) // 64
    s[~np.isin(word, (0, 1, 5, 10)) | (rng.random(n) < 0.3)] = NEG_INF
    add("dead_words_between_alive", b, s, 0.5, presorted=True)
    # One alive box in the last, ragged word (192..199), a jittered copy
    # of an alive box of word 0.
    n = 200
    b = clustered_boxes(rng, n)
    s = np.linspace(1.0, 0.01, n, dtype=np.float32)
    s[rng.random(n) < 0.5] = NEG_INF
    s[192:] = NEG_INF
    first = int(np.flatnonzero(s > NEG_INF)[0])
    b[197] = b[first] + rng.uniform(-1, 1, 4).astype(np.float32)
    s[197] = np.float32(0.005)
    add("one_alive_in_ragged_word", b, s, 0.5, presorted=True)
    # A NaN coordinate in a dead box (word 1) and in an alive one (word 3,
    # a copy of an alive box of word 0): the alive one removes nothing and
    # is never removed.
    n = 320
    b = clustered_boxes(rng, n, clusters=3)
    descending = np.linspace(1.0, 0.01, n, dtype=np.float32)
    s = np.where(rng.random(n) < 0.2, NEG_INF, descending)
    s[70], s[200] = NEG_INF, descending[200]
    b[70, 0] = np.nan
    b[200] = b[int(np.flatnonzero(s > NEG_INF)[0])]
    b[200, 3] = np.nan
    add("nan_in_dead_and_alive_box", b, s, 0.5, presorted=True)
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
                scores=s, thr=0.5, categories=None, expect=None,
                presorted=False)


def expected_chain(case):
    """The keep list of a ``_chain`` case: every box but B."""
    keep = np.argsort(-case["scores"], kind="stable")
    b = np.flatnonzero((case["boxes"] == [2, 0, 12, 10]).all(axis=1))[0]
    return [int(i) for i in keep if i != b]


def sorted_problem(case):
    """(boxes sorted by descending score, stable, or as they are for a
    ``presorted`` case; alive mask) of a case, the inputs of
    ``_alive_sorted``."""
    if case["presorted"]:
        return case["boxes"], case["scores"] > NEG_INF
    order = np.argsort(-case["scores"], kind="stable")
    return case["boxes"][order], case["scores"][order] > NEG_INF
