"""``cli.generate_psfs`` held against the JAX package's on the CPU: the
``P{p}E{e}/I{idx:06d}`` layout of extensionless fp16 files with JAX's
per-slice offsets (``num_psfs // num_workers`` each), PSFs of each
folder's exposure and centred in the central window, and banks of either
writer read back identically by both packages' ``load_psf_bank``."""

import os

import numpy as np
import pytest

from torch_threads import one_thread  # noqa: F401 (autouse fixture)

import detectinblur_tpu.cli.generate_psfs as jax_gen
from detectinblur_tpu.data import blur_sampling as jax_bs
import detectinblur_tpu_torch.cli.generate_psfs as gen
from detectinblur_tpu_torch.data import blur_sampling as bs
from detectinblur_tpu_torch.ops.psf import BLUR_FRACTIONS, BLUR_PARAMS

FOLDERS = [f"P{p}E{e}" for p in range(1, 4) for e in range(5)]


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    """The port's bank from two slices of ``--num_psfs 5 --num_workers
    2`` (2 PSFs each: I000000-I000003), and JAX's from one slice."""
    root = tmp_path_factory.mktemp("banks")
    ours, ref = str(root / "ours"), str(root / "jax")
    runs = [gen.main(["--output_path", ours, "--num_psfs", "5",
                      "--num_workers", "2", "--slice_index", str(s),
                      "--batch", "2", "--device", "cpu"]) for s in (0, 1)]
    jax_gen.main(["--output_path", ref, "--num_psfs", "2", "--batch", "2"])
    return ours, ref, runs


def test_layout_dtype_and_slices(banks):
    ours, ref, runs = banks
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)) == sorted(FOLDERS)
    for folder in FOLDERS:
        assert sorted(os.listdir(os.path.join(ours, folder))) == [
            f"I{i:06d}" for i in range(4)]
        for name in os.listdir(os.path.join(ours, folder)):
            with open(os.path.join(ours, folder, name), "rb") as f:
                psf = np.load(f)
            assert psf.dtype == np.float16 and psf.shape == (128, 128)
    assert runs == [{"psfs": 30, "seconds": runs[0]["seconds"]},
                    {"psfs": 30, "seconds": runs[1]["seconds"]}]


def test_psfs_have_their_exposure_and_fit_the_window(banks):
    """Each PSF's mass is its folder's exposure fraction within 0.02 and
    its centre of mass within 4 pixels of the window's middle; the two
    slices draw different PSFs."""
    ours, _, _ = banks
    bank = bs.load_psf_bank(ours)
    assert bank.shape == (3, 5, 4, 128, 128) and bank.dtype == np.float32
    mass = bank.sum((3, 4))
    want = np.broadcast_to(np.asarray(BLUR_FRACTIONS)[None, :, None],
                           mass.shape)
    np.testing.assert_allclose(mass, want, atol=0.02)
    assert (bank >= 0).all()
    ys, xs = np.arange(128)[:, None], np.arange(128)[None]
    cy = (bank * ys).sum((3, 4)) / mass
    cx = (bank * xs).sum((3, 4)) / mass
    assert np.abs(cy - 64).max() < 4 and np.abs(cx - 64).max() < 4
    assert not np.array_equal(bank[:, :, 0], bank[:, :, 2])
    assert len(BLUR_PARAMS) == bank.shape[0]


@pytest.mark.parametrize("writer", ["ours", "jax"])
def test_banks_read_back_alike_in_both_packages(banks, writer):
    ours, ref, _ = banks
    root = ours if writer == "ours" else ref
    for kw in ({}, {"bank_size": 2}, {"max_bank": 1, "epoch": 1}):
        a = bs.load_psf_bank(root, **kw)
        b = jax_bs.load_psf_bank(root, **kw)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_full_canvas_bank_is_cropped_on_load(tmp_path):
    """``--crop 0`` keeps the whole canvas; both loaders cut its central
    128x128 alike."""
    out = str(tmp_path / "full")
    gen.main(["--output_path", out, "--num_psfs", "1", "--canvas", "160",
              "--max_len", "40", "--crop", "0", "--device", "cpu"])
    with open(os.path.join(out, "P1E4", "I000000"), "rb") as f:
        psf = np.load(f)
    assert psf.dtype == np.float16 and psf.shape == (160, 160)
    a, b = bs.load_psf_bank(out), jax_bs.load_psf_bank(out)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[0, 4, 0], psf[16:144, 16:144])


def test_generate_psfs_defaults_and_cuda():
    """JAX's flags and defaults, and ``--device`` cuda unless asked."""
    import torch

    ours = gen.parser().parse_args(["--output_path", "o"])
    assert (ours.num_psfs, ours.slice_index, ours.num_workers, ours.canvas,
            ours.max_len, ours.crop, ours.batch, ours.device) == (
        12000, 0, 1, 256, 96.0, 128, 128, "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gen.main(["--output_path", "o"])
