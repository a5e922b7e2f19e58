"""The port's NMS (``detectinblur_tpu_torch/ops/nms.py``) held exactly
against JAX's (``detectinblur_tpu/ops/nms.py``) on the hard cases of
``tests/nms_cases.py``, on the CPU, where ``_alive_sorted`` runs the plain
version of the kernel ``csrc/nms.cu``: equal alive masks, and equal
indices, order, padding and ``valid`` masks from ``nms``,
``grouped_nms_presorted`` and ``batched_nms``. The plain version of the
mask kernel (``_suppression_mask_plain``) is held against JAX's pairwise
IoU, and a greedy walk that reads only the words the mask kernel must
write against both packages' alive masks. The kernels themselves are held
against the plain versions on the card (``tests/test_torch_port_cuda.py``,
``chip_smoke.py``)."""

import functools
import types

import jax
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse fixture)

import nms_cases
from detectinblur_tpu.ops import nms as jax_nms
from detectinblur_tpu_torch.ops import nms

CASES = {c["name"]: c for c in nms_cases.cases()}
FIRST = ("iou_equals_thr_0.7", "iou_equals_thr_0.3", "chain_across_64",
         "chain_at_64_and_128", "clustered_n63", "clustered_n64",
         "clustered_n65", "clustered_n127", "clustered_n129")
ORDER = FIRST + tuple(n for n in CASES if n not in FIRST)
T = torch.from_numpy


def _kept(idxs, valid):
    return np.asarray(idxs)[np.asarray(valid)].tolist()


def _jax_alive(sboxes, salive, thr):
    return np.asarray(jax.jit(jax_nms._alive_sorted, static_argnums=2)(
        sboxes, salive, thr))


@functools.cache
def _jax_iou_mat():
    """JAX's ``iou_mat``, the pairwise IoU that ``_alive_sorted`` defines
    inside itself, rebuilt from that function's code (it closes over
    nothing) and jitted."""
    code = next(c for c in jax_nms._alive_sorted.__code__.co_consts
                if getattr(c, "co_name", "") == "iou_mat")
    assert not code.co_freevars
    return jax.jit(types.FunctionType(code, vars(jax_nms)))


def _packed(sup):
    """[R, N] bool -> [R, ceil(N/64)] uint64: bit j of word w is column
    64 w + j."""
    R, N = sup.shape
    words = -(-N // 64)
    padded = np.zeros((R, words * 64), bool)
    padded[:, :N] = sup
    return np.packbits(padded.reshape(R, words, 64), axis=-1,
                       bitorder="little").view("<u8")[..., 0]


def _plain_words(sboxes, salive, thr):
    """(the plain mask's words as uint64 [N, stride], the covered ones)."""
    b, a = T(sboxes)[None], T(salive)[None]
    words = nms._suppression_mask_plain(b, a, thr)[0].numpy().view(np.uint64)
    return words, nms._covered_words(a)[0].numpy()


def _greedy_walk(words, alive):
    """Greedy NMS over the mask's words that reads only those the mask
    kernel must write: a row's words from its own on, and only when the
    row is kept (kept rows are alive)."""
    removed = np.zeros(words.shape[1], np.uint64)
    keep = np.zeros(len(alive), bool)
    for r in np.flatnonzero(alive):
        w, bit = divmod(int(r), 64)
        if (int(removed[w]) >> bit) & 1:
            continue
        keep[r] = True
        removed[w:] |= words[r, w:]
    return keep


@pytest.mark.parametrize("name", ORDER)
def test_alive_sorted_matches_jax(name):
    case = CASES[name]
    sboxes, salive = nms_cases.sorted_problem(case)
    before = nms.nms_alive.launches
    got = nms._alive_sorted(T(sboxes)[None], T(salive)[None], case["thr"])
    assert nms.nms_alive.launches == before    # the CPU runs no kernel
    np.testing.assert_array_equal(got[0].numpy(),
                                  _jax_alive(sboxes, salive, case["thr"]))


@pytest.mark.parametrize("name", ORDER)
def test_suppression_mask_plain_matches_jax(name):
    """On the words the mask kernel must write (alive rows, from the
    row's own word on), the plain mask is JAX's ``iou_mat(...) > thr``
    over later alive columns; every other word is 0."""
    case = CASES[name]
    sboxes, salive = nms_cases.sorted_problem(case)
    got, covered = _plain_words(sboxes, salive, case["thr"])
    N = len(salive)
    later = np.arange(N)[:, None] < np.arange(N)[None, :]
    sup = ((np.asarray(_jax_iou_mat()(sboxes, sboxes))
            > np.float32(case["thr"])) & salive[None, :] & later)
    want = np.zeros_like(got)
    want[:, :-(-N // 64)] = _packed(sup)
    np.testing.assert_array_equal(got, np.where(covered, want, 0))


@pytest.mark.parametrize("name", ORDER)
def test_greedy_walk_over_covered_words_matches_jax(name):
    """With noise in every word the mask kernel may leave unwritten, a
    greedy walk over the plain mask's words gives the plain version's and
    JAX's alive masks: the scan never needs those words."""
    case = CASES[name]
    sboxes, salive = nms_cases.sorted_problem(case)
    words, covered = _plain_words(sboxes, salive, case["thr"])
    noise = np.random.default_rng(0).integers(0, 2**64, words.shape,
                                              dtype=np.uint64)
    keep = _greedy_walk(np.where(covered, words, noise), salive)
    plain = nms._alive_sorted_plain(T(sboxes)[None], T(salive)[None],
                                    case["thr"])
    np.testing.assert_array_equal(keep, plain[0].numpy())
    np.testing.assert_array_equal(keep,
                                  _jax_alive(sboxes, salive, case["thr"]))


@pytest.mark.parametrize("name", ORDER)
def test_nms_matches_jax(name):
    """Every slot, with fewer outputs than boxes, as many, and more
    (padding)."""
    case = CASES[name]
    n = len(case["scores"])
    for max_out in sorted({max(1, n // 3), n, n + 3}):
        ji, jv = jax_nms.nms(case["boxes"], case["scores"], case["thr"],
                             max_out)
        ti, tv = nms.nms(T(case["boxes"]), T(case["scores"]), case["thr"],
                         max_out)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if case["expect"] is not None:
        assert _kept(ti, tv) == case["expect"]
    if name.startswith("chain"):
        assert _kept(ti, tv) == nms_cases.expected_chain(case)


def _groups(names):
    """The named cases as presorted groups of one length (dead tails)."""
    K = max(len(CASES[n]["scores"]) for n in names)
    bx = np.zeros((len(names), K, 4), np.float32)
    sc = np.full((len(names), K), nms_cases.NEG_INF, np.float32)
    for g, n in enumerate(names):
        order = np.argsort(-CASES[n]["scores"], kind="stable")
        bx[g, :len(order)] = CASES[n]["boxes"][order]
        sc[g, :len(order)] = CASES[n]["scores"][order]
    return bx, sc


@pytest.mark.parametrize("names", [
    ("iou_equals_thr_0.7", "identical_equal_scores", "zero_area",
     "all_dead"),
    ("chain_across_64", "chain_at_64_and_128", "clustered_n65",
     "clustered_n129"),
    ("clustered_n1", "clustered_n63", "clustered_n64", "clustered_n127"),
], ids=["small", "chains", "sizes"])
def test_grouped_nms_presorted_matches_jax(names):
    """Groups in one call, as the RPN's (image, level) groups; the
    threshold is each set's first case's."""
    bx, sc = _groups(names)
    thr = CASES[names[0]]["thr"]
    G, K = sc.shape
    for max_out in (K, G * K + 5):
        ji, jv = jax_nms.grouped_nms_presorted(bx, sc, thr, max_out)
        ti, tv = nms.grouped_nms_presorted(T(bx), T(sc), thr, max_out)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_grouped_nms_presorted_leading_dims_match_jax():
    """[B, G, K]: each image's groups equal JAX's call on that image."""
    (bx0, sc0), (bx1, sc1) = (_groups(("clustered_n127", "chain_at_64_and_128")),
                              _groups(("clustered_n129", "chain_across_64")))
    bxs, scs = np.stack([bx0, bx1]), np.stack([sc0, sc1])
    ti, tv = nms.grouped_nms_presorted(T(bxs), T(scs), 0.5, 300)
    for b in range(2):
        ji, jv = jax_nms.grouped_nms_presorted(bxs[b], scs[b], 0.5, 300)
        np.testing.assert_array_equal(ti[b].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv[b].numpy(), np.asarray(jv))


@pytest.mark.parametrize("name", ["categories_90_canvas_1333",
                                  "iou_equals_thr_0.7", "all_dead"])
def test_batched_nms_matches_jax(name):
    """The coordinate-offset trick, float32 rounding of the shifted boxes
    included (offsets up to ~1.2e5 on the 1333 canvas)."""
    case = CASES[name]
    n = len(case["scores"])
    cats = case["categories"]
    if cats is None:
        cats = np.ones(n, np.int32)
    for max_out in (100, n + 2):
        ji, jv = jax_nms.batched_nms(case["boxes"], case["scores"], cats,
                                     case["thr"], max_out)
        ti, tv = nms.batched_nms(T(case["boxes"]), T(case["scores"]),
                                 T(cats), case["thr"], max_out)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
