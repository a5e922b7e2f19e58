"""The port's data path held against the JAX package on the CPU: blur
decisions, stored PSF banks, batch assembly, the COCO dataset and the
loader must match exactly (same numpy RNG streams, same bytes)."""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from synthetic_coco import write_coco

from detectinblur_tpu.data import batching as jax_batching
from detectinblur_tpu.data import blur_sampling as jax_bs
from detectinblur_tpu.data import loader as jax_loader
from detectinblur_tpu.data.coco import CocoDetection as JaxCocoDetection
from detectinblur_tpu.data.coco import get_coco as jax_get_coco
from detectinblur_tpu_torch.data import batching, blur_sampling as bs, loader
from detectinblur_tpu_torch.data.coco import CocoDetection, get_coco
from detectinblur_tpu_torch.ops import psf as psf_mod

POLICIES = {
    "default": dict(prob=0.9),
    "low": dict(prob=0.75, low_exposure=True),
    "high": dict(prob=1.0, high_exposure=True),
    "sweep": dict(prob=1.0, blur_type=0.001, blur_exposure=0.2),
    "negligible": dict(prob=1.0, blur_type=0.01, blur_exposure=1 / 100),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_sample_blur_decision_matches_jax(name):
    """Exact: 200 decisions from one seeded stream, field by field."""
    ours_rng, ref_rng = (np.random.default_rng(5) for _ in range(2))
    ours_p = bs.BlurPolicy(**POLICIES[name])
    ref_p = jax_bs.BlurPolicy(**POLICIES[name])
    for _ in range(200):
        ours = bs.sample_blur_decision(ours_rng, ours_p, bank_size=37)
        ref = jax_bs.sample_blur_decision(ref_rng, ref_p, bank_size=37)
        assert dataclasses.astuple(ours) == dataclasses.astuple(ref)


def test_lehe_decision_raises_as_in_jax():
    """LEHE_FRACTION_WEIGHTS sum to 0.9375, the blur share: they are joint
    shares, so JAX's fraction draw, which takes them as they are, raises
    (a fault of the reference). The port divides them by their sum: over
    40000 seeded decisions no blur, each low exposure and each high
    exposure come within 0.6 points of 6.25%, 6.25% and 37.5% (2.5
    standard errors of the largest share, 0.24 points)."""
    assert sum(bs.LEHE_FRACTION_WEIGHTS) == 0.9375
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="sum to 1"):
        for _ in range(20):
            jax_bs.sample_blur_decision(rng,
                                        jax_bs.BlurPolicy(lehe_blur_seg=True))
    rng = np.random.default_rng(0)
    policy = bs.BlurPolicy(lehe_blur_seg=True)
    counts = np.zeros(6)
    for _ in range(40000):
        d = bs.sample_blur_decision(rng, policy)
        counts[d.fraction_index + 1 if d.blurring else 0] += 1
    np.testing.assert_allclose(counts / counts.sum(),
                               [0.0625, 0.0625, 0.0625, 0.0625, 0.375, 0.375],
                               atol=0.006)


def test_constants_match_jax():
    from detectinblur_tpu.ops import psf as jax_psf

    for k in ("BLUR_PARAMS", "BLUR_FRACTIONS", "EVAL_PARAMS", "EVAL_FRACTIONS"):
        assert tuple(getattr(psf_mod, k)) == tuple(getattr(jax_psf, k))
    assert bs.LEHE_FRACTION_WEIGHTS == jax_bs.LEHE_FRACTION_WEIGHTS
    assert batching.GT_BUCKETS == jax_batching.GT_BUCKETS
    assert batching.DEFAULT_SOURCE_BUCKETS == jax_batching.DEFAULT_SOURCE_BUCKETS


@pytest.fixture(scope="module")
def stored_bank(tmp_path_factory):
    """The reference's layout: P{p}E{f}/I{idx:06d}, fp16 256x256, written
    extensionless through an open handle; one folder uses .npy names."""
    rng = np.random.default_rng(3)
    root = tmp_path_factory.mktemp("psfs")
    for p in range(1, 4):
        for f in range(5):
            folder = root / f"P{p}E{f}"
            folder.mkdir()
            for i in range(7):
                psf = rng.random((256, 256)).astype(np.float16)
                if (p, f) == (2, 3):
                    np.save(folder / f"I{i:06d}.npy", psf)
                else:
                    with open(folder / f"I{i:06d}", "wb") as fh:
                        np.save(fh, psf)
    return str(root)


@pytest.mark.parametrize("kw", [dict(), dict(max_bank=3, epoch=1),
                                dict(bank_size=4, max_bank=2, epoch=3)],
                         ids=["autodetect", "stride", "stride-epoch"])
def test_load_psf_bank_matches_jax(stored_bank, kw):
    """Exact, 256 -> 128 central crop, stride subsampling and epoch offset."""
    ours = bs.load_psf_bank(stored_bank, **kw)
    ref = jax_bs.load_psf_bank(stored_bank, **kw)
    assert ours.dtype == np.float32 and ours.shape[-2:] == (128, 128)
    np.testing.assert_array_equal(ours, ref)


def test_load_psf_bank_incomplete_raises(stored_bank):
    with pytest.raises(FileNotFoundError):
        bs.load_psf_bank(stored_bank, bank_size=9)


def test_generate_psf_bank_on_cpu():
    """Shape and layout of a tiny bank: each PSF's mass is at most its
    bin's exposure fraction (the 128 crop can only lose mass), the same
    seed gives the same bank, and --dont_center_psf changes it."""
    params, fractions = (0.005, 0.00005), (0.1, 1.0)
    make = lambda center=True: bs.generate_psf_bank(
        torch.Generator().manual_seed(7), bank_size=3, params=params,
        fractions=fractions, iters=64, batch=5, center=center)
    bank = make()
    assert bank.shape == (2, 2, 3, 128, 128) and bank.dtype == np.float32
    mass = bank.sum(axis=(-2, -1))
    assert (mass <= np.asarray(fractions)[None, :, None] * (1 + 1e-5)).all()
    assert (mass > 0).all()
    np.testing.assert_array_equal(bank, make())
    assert not np.array_equal(bank, make(center=False))


def test_bucket_helpers_match_jax():
    buckets = ((96, 128), (128, 96), (128, 128))
    for h, w in [(80, 120), (120, 80), (128, 128), (200, 90), (10, 10)]:
        assert batching.pick_bucket(h, w, buckets) == \
            jax_batching.pick_bucket(h, w, buckets)
    for b in jax_batching.DEFAULT_SOURCE_BUCKETS + ((480, 640),):
        assert batching.model_bucket_for(b) == jax_batching.model_bucket_for(b)
    hw = np.array([[427, 640], [500, 375]])
    assert batching.model_bucket_for_batch(hw) == \
        jax_batching.model_bucket_for_batch(hw)


@pytest.mark.parametrize("counts", [[], [0], [3, 8], [9], [17, 2], [64], [65],
                                    [150], [120, 3]])
def test_gt_bucket_for_batch_matches_jax(counts):
    for max_gt in (100, 50):
        assert batching.gt_bucket_for_batch(counts, max_gt) == \
            jax_batching.gt_bucket_for_batch(counts, max_gt)


def _items(rng, sizes, n_boxes):
    items = []
    for k, ((h, w), n) in enumerate(zip(sizes, n_boxes)):
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        if k == 1:   # a float item quantizes to uint8 on both sides
            img = rng.random((h, w, 3)).astype(np.float32)
        boxes = rng.uniform(0, min(h, w) / 2, (n, 4)).astype(np.float32)
        boxes[:, 2:] += rng.uniform(2, min(h, w) / 2, (n, 2))
        items.append({"image": img, "image_id": k + 1, "boxes": boxes,
                      "labels": rng.integers(1, 91, n).astype(np.int32),
                      "area": np.ones(n, np.float32),
                      "iscrowd": np.zeros(n, np.int32)})
    return items


def _assert_batch_equal(ours, ref):
    """A port BlurBatch (CPU tensors) against a JAX one, field by field."""
    for name in batching.BlurBatch._fields:
        o, r = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert o.shape == r.shape, name
        np.testing.assert_array_equal(o, r, err_msg=name)
    assert ours.images.dtype == torch.uint8
    assert ours.gt_labels.dtype == torch.int64


@pytest.mark.parametrize("bucket_gt", [True, False])
def test_build_blur_batch_matches_jax(bucket_gt):
    """Exact: images (uint8 and float items), sizes, PSFs picked from the
    bank (including a negligible-exposure and an unblurred item), GT
    padding at the GT bucket or at max_gt, and over-full GT truncated."""
    rng = np.random.default_rng(11)
    items = _items(rng, [(60, 80), (80, 50), (64, 64), (40, 70)],
                   [3, 0, 12, 30])
    bank = rng.random((3, 5, 4, 128, 128)).astype(np.float32)
    decisions = [(True, 1, 2, 9), (True, 0, -1, 3), (False, -1, -1, 0),
                 (True, 2, 4, 1)]
    ours = batching.build_blur_batch(
        items, [bs.BlurDecision(*d) for d in decisions], bank, (96, 96),
        max_gt=20, bucket_gt=bucket_gt)
    ref = jax_batching.build_blur_batch(
        items, [jax_bs.BlurDecision(*d) for d in decisions], bank, (96, 96),
        max_gt=20, bucket_gt=bucket_gt)
    _assert_batch_equal(ours, ref)
    assert ours.blurring.tolist() == [True, False, False, True]


def test_hflip_item_matches_jax():
    rng = np.random.default_rng(2)
    item = _items(rng, [(30, 50)], [4])[0]
    ours, ref = batching.hflip_item(item), jax_batching.hflip_item(item)
    np.testing.assert_array_equal(ours["image"], ref["image"])
    np.testing.assert_array_equal(ours["boxes"], ref["boxes"])


SPLITS = {"train2017": [(40, 48), (48, 40), (36, 48), (48, 36), (44, 44),
                        (40, 40), (30, 48)],
          "val2017": [(40, 48), (48, 40), (44, 44), (36, 48), (40, 40)]}


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return write_coco(str(tmp_path_factory.mktemp("coco")), SPLITS, seed=0,
                      n_cats=6, boxes=(0, 4), extras=True)


@pytest.mark.parametrize("split", ["train", "val"])
def test_coco_items_match_jax(coco_root, split):
    """Exact items: the crowd box and the box past the image edge drop, the
    train split drops images without a usable box."""
    ours, ref = get_coco(coco_root, split), jax_get_coco(coco_root, split)
    assert ours.ids == ref.ids and len(ours) == len(ref)
    if split == "val":
        assert len(ours) == len(SPLITS["val2017"])
    for i in range(len(ours)):
        o, r = ours[i], ref[i]
        assert set(o) == set(r)
        assert o["image_id"] == r["image_id"]
        for k in ("image", "boxes", "labels", "area", "iscrowd"):
            assert o[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(o[k], r[k], err_msg=k)


def test_coco_masks_and_keypoints_raise(coco_root):
    """The synthetic instances carry no segmentation: with masks, the
    items raise KeyError in both packages; with keypoints, which they do
    not carry either, each item has [N, 0, 3] keypoints, as JAX's."""
    folder = os.path.join(coco_root, "val2017")
    ann = os.path.join(coco_root, "annotations", "instances_val2017.json")
    for cls in (CocoDetection, JaxCocoDetection):
        with pytest.raises(KeyError, match="segmentation"):
            cls(folder, ann, with_masks=True)[0]
    ours = CocoDetection(folder, ann, with_keypoints=True)
    ref = JaxCocoDetection(folder, ann, with_keypoints=True)
    for i in range(len(ours)):
        o, r = ours[i]["keypoints"], ref[i]["keypoints"]
        assert o.dtype == r.dtype and o.shape == (len(ours[i]["boxes"]), 0, 3)
        np.testing.assert_array_equal(o, r)


LOADER_CASES = [(w, p, d) for w in (0, 2) for p in (1, 2) for d in (True, False)]


@pytest.mark.parametrize("workers,processes,drop_last", LOADER_CASES,
                         ids=[f"w{w}-p{p}-{'drop' if d else 'keep'}"
                              for w, p, d in LOADER_CASES])
def test_loader_batches_match_jax(coco_root, monkeypatch, workers, processes,
                                  drop_last):
    """Exact batches, buckets and ids for every process of a sharded,
    shuffled, flipped, blurred epoch (epoch 1, so set_epoch counts)."""
    buckets = ((48, 48), (40, 48))
    monkeypatch.setattr(batching, "DEFAULT_SOURCE_BUCKETS", buckets)
    monkeypatch.setattr(jax_batching, "DEFAULT_SOURCE_BUCKETS", buckets)
    bank = np.random.default_rng(4).random((3, 5, 3, 128, 128)).astype(np.float32)
    kw = dict(batch_size=2, psf_bank=bank, shuffle=True, hflip_prob=0.5,
              num_processes=processes, drop_last=drop_last, seed=9)
    ours_ds, ref_ds = get_coco(coco_root, "train"), jax_get_coco(coco_root, "train")
    for rank in range(processes):
        ours = loader.DetectionLoader(
            ours_ds, policy=bs.BlurPolicy(prob=0.6), process_index=rank,
            num_workers=workers, **kw)
        ref = jax_loader.DetectionLoader(
            ref_ds, policy=jax_bs.BlurPolicy(prob=0.6), process_index=rank,
            num_workers=workers, **kw)
        ours.set_epoch(1)
        ref.set_epoch(1)
        assert len(ours) == len(ref)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) and got
        for (ob, obucket, oids), (rb, rbucket, rids) in zip(got, want):
            assert obucket == rbucket and oids == rids
            _assert_batch_equal(ob, rb)


def test_loader_raises_what_the_dataset_raises():
    """A failing item reaches the consumer (the JAX loader's iteration
    just ends early), and an early stop ends the producer thread."""
    class Broken:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 3:
                raise OSError("bad image 3")
            img = np.zeros((20, 20, 3), np.uint8)
            return {"image": img, "image_id": i, "boxes": np.zeros((0, 4), np.float32),
                    "labels": np.zeros(0, np.int32)}

    before = set(threading.enumerate())
    for workers in (0, 2):
        it = loader.DetectionLoader(Broken(), 1, shuffle=False,
                                    source_buckets=((32, 32),),
                                    num_workers=workers)
        with pytest.raises(OSError, match="bad image 3"):
            list(it)
        gen = iter(it)
        next(gen)
        gen.close()
    assert not [t for t in threading.enumerate()
                if t not in before and t.is_alive()]


def test_loader_refuses_augmix(coco_root, monkeypatch):
    """AugMix is ported: a loader given ``augmix`` no longer refuses it,
    and its batches are the JAX loader's, exactly (the AugMix cases of
    tests/test_torch_port_remedies.py cover the positional ops)."""
    monkeypatch.setattr(batching, "DEFAULT_SOURCE_BUCKETS", ((48, 48),))
    monkeypatch.setattr(jax_batching, "DEFAULT_SOURCE_BUCKETS", ((48, 48),))
    kw = dict(batch_size=2, shuffle=True, hflip_prob=0.5, num_workers=2,
              augmix={"positional": False})
    got = list(loader.DetectionLoader(get_coco(coco_root, "train"), **kw))
    want = list(jax_loader.DetectionLoader(jax_get_coco(coco_root, "train"),
                                           **kw))
    assert len(got) == len(want) and got
    for (ob, _, oids), (rb, _, rids) in zip(got, want):
        assert oids == rids
        _assert_batch_equal(ob, rb)
