"""The port's host-to-device helpers (``utils/device.py``) and what uses
them, on the CPU: the per-device constant cache, the pinned non-blocking
copy, the eval batch's ``to_device``, the loader's pinning switch, and the
NMS kernel's padded bitmask stride. On a card the same helpers keep
predict and the eval step free of host syncs
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` phases 4 and 8);
the parity tests of predict, the eval step and ``cli.evaluate`` against
JAX show that no result moved."""

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse fixture)

from detectinblur_tpu_torch.data.loader import DetectionLoader
from detectinblur_tpu_torch.models.detection_transform import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    normalize_image,
    preprocess_batch,
)
from detectinblur_tpu_torch.ops import nms
from detectinblur_tpu_torch.ops.roi_align import LEVEL_SCALES
from detectinblur_tpu_torch.train.engine import BlurBatch, to_device
from detectinblur_tpu_torch.utils.device import (
    device_constant,
    to_device_async,
)

LEVELS = ((200, 272), (100, 136), (50, 68), (25, 34))


@pytest.mark.parametrize("values, dtype", [
    (IMAGENET_MEAN, torch.float32), (IMAGENET_STD, torch.float32),
    (LEVEL_SCALES, torch.float32), (LEVELS, torch.int32)])
def test_device_constant_is_one_tensor_per_device_and_dtype(values, dtype):
    got = device_constant(values, "cpu", dtype)
    assert device_constant(values, torch.device("cpu"), dtype) is got
    assert torch.equal(got, torch.tensor(values, dtype=dtype))
    assert got.dtype == dtype and not got.is_pinned()
    other = device_constant(values, "cpu", torch.float64)
    assert other is not got and other.dtype == torch.float64
    assert torch.equal(other, torch.tensor(values, dtype=torch.float64))


@pytest.mark.parametrize("value", [
    np.array([[480, 640], [427, 640]], np.int64),
    np.array([0.5, 1.5], np.float32),
    [[3, 4], [5, 6]],
    torch.tensor([[7, 8]], dtype=torch.int32),
], ids=["int64", "float32", "list", "tensor"])
def test_to_device_async_on_cpu_is_as_tensor(value):
    got = to_device_async(value, "cpu")
    want = torch.as_tensor(value)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert got.device.type == "cpu" and not got.is_pinned()


def test_normalize_and_preprocess_read_the_cached_statistics():
    """ImageNet's statistics from the cache: the same numbers as a fresh
    ``torch.tensor`` of them, and the new sizes an int64 tensor equal to
    the host computation."""
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((2, 40, 56, 3), np.float32))
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32)
    assert torch.equal(normalize_image(img[0]), (img[0] - mean) / std)
    hw = np.array([[40, 56], [33, 50]])
    out, new_hw = preprocess_batch(img, hw, (64, 96), 60, 96)
    assert new_hw.dtype == torch.int64 and new_hw.device.type == "cpu"
    assert new_hw.tolist() == [[60, 84], [60, 90]]
    assert out.shape == (2, 64, 96, 3)


def _cpu_batch():
    rng = np.random.default_rng(1)
    return BlurBatch(
        images=torch.from_numpy(rng.integers(0, 255, (1, 32, 48, 3),
                                             dtype=np.uint8)),
        hw=torch.tensor([[30, 40]]), psfs=torch.rand(1, 128, 128),
        blurring=torch.tensor([True]), gt_boxes=torch.rand(1, 3, 4) * 20,
        gt_labels=torch.tensor([[1, 2, 3]]),
        gt_valid=torch.tensor([[True, True, False]]),
        param_index=torch.tensor([2], dtype=torch.int32))


def test_to_device_of_an_unpinned_cpu_batch_is_unchanged():
    batch = _cpu_batch()
    got = to_device(batch, torch.device("cpu"))
    assert got.hw is batch.hw
    for name, g, b in zip(BlurBatch._fields, got, batch):
        if b is None:
            assert g is None, name
            continue
        assert g.device.type == "cpu" and g.dtype == b.dtype, name
        assert torch.equal(g, b) and not g.is_pinned(), name


class _Tiny:
    def __len__(self):
        return 3

    def __getitem__(self, i):
        return {"image": np.full((20, 24, 3), i, np.uint8), "image_id": i,
                "boxes": np.array([[1, 2, 10, 12]], np.float32),
                "labels": np.array([1], np.int64)}


def test_loader_pins_nothing_unless_asked():
    """The CLIs ask for pinned batches only on a card; by default (and so
    on the CPU) the batches are the plain tensors they were."""
    got = list(DetectionLoader(_Tiny(), 1, shuffle=False,
                               source_buckets=((32, 32),)))
    assert len(got) == 3
    for batch, _, _ in got:
        assert not any(t.is_pinned() for t in batch if t is not None)


@pytest.mark.parametrize("n", [1, 64, 65, 129, 192, 200, 320, 4096, 4097,
                               16385])
def test_nms_mask_stride_is_even_and_covers_the_words(n):
    words = -(-n // 64)
    stride = nms.mask_stride(n)
    assert stride % 2 == 0 and words <= stride <= words + 1
