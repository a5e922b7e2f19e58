"""The port's blur-estimator trainer, ``cli.train_blur_estimator``, held
against the JAX package's on the CPU (``--test_only`` from the same
weights: top-1, top-2 and the confusion matrix), its training run and
checkpoint, and its refusals. The synthetic COCO, the PSF bank and the
96x96 model bucket are ``tests/test_torch_port_cli.py``'s fixtures."""

import functools

import numpy as np
import pytest
import torch

from remedy_helpers import resnet18_sd
from test_torch_port_cli import SIZES, bank, coco_root, tiny  # noqa: F401
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

import detectinblur_tpu.cli.train_blur_estimator as jax_cli_est
import detectinblur_tpu.utils.torch_convert as jax_torch_convert
import detectinblur_tpu_torch.cli.train_blur_estimator as cli_est
from detectinblur_tpu_torch.models.classifier import ResNetClassifier
from detectinblur_tpu_torch.utils.convert import classifier_from_torchvision


def test_estimator_cli_test_only_matches_jax(coco_root, tiny, tmp_path,
                                             monkeypatch, capsys):
    """``cli.train_blur_estimator --test_only --LEHE --crop_images`` of
    both packages from the same resnet18 .pth (its fc loaded on both
    sides in place of the fresh head) on the same synthetic COCO and PSF
    bank: the same top-1, top-2, mean per-class accuracy (to the 4
    printed decimals) and confusion matrix."""
    sd = resnet18_sd(4, seed=3)
    path = tmp_path / "resnet18.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    monkeypatch.setattr(cli_est, "classifier_from_torchvision", functools.partial(
        classifier_from_torchvision, include_fc=True))
    monkeypatch.setattr(
        jax_torch_convert, "convert_resnet_classifier_state_dict",
        functools.partial(jax_torch_convert.convert_resnet_classifier_state_dict,
                          include_fc=True))
    argv = ["--data-path", coco_root, "--test_only", "--LEHE",
            "--crop_images", "--start_from_weights", str(path), "-b", "2",
            "--workers", "2"]
    (tmp_path / "ref").mkdir()
    ours = cli_est.main(argv + ["--device", "cpu",
                                "--output_dir", str(tmp_path / "ours")])
    printed = capsys.readouterr().out
    ref_top1 = jax_cli_est.main(argv + ["--output_dir", str(tmp_path / "ref")])
    ref_printed = capsys.readouterr().out
    line = lambda out: next(l for l in out.splitlines() if l.startswith("Top1"))
    assert line(printed) == line(ref_printed)
    assert ours.top1 == pytest.approx(float(ref_top1), abs=1e-12)
    ref_cm = np.load(tmp_path / "ref" / "confusion_matrix.npy")
    np.testing.assert_array_equal(ours.confusion, ref_cm)
    np.testing.assert_array_equal(
        np.load(tmp_path / "ours" / "confusion_matrix.npy"), ref_cm)
    assert ours.confusion.sum() == len(SIZES["val2017"])
    assert ours.state.step == 0


def test_estimator_cli_trains_and_checkpoints(coco_root, tiny, tmp_path):
    """``cli.train_blur_estimator --LEHE_blur_seg`` with the corruptions,
    quantization, --resize_images and --crop_images on --device cpu: two
    finite steps from scratch (the batch at index ``early_stop`` is the
    last, as in JAX) move every parameter, the BatchNorm affines too, and
    ``model_0.pt`` gives back the weights and running statistics bit for
    bit."""
    from detectinblur_tpu_torch.train.checkpoint import restore_checkpoint
    from detectinblur_tpu_torch.train.state import TrainState

    out = tmp_path / "est"
    start = ResNetClassifier("resnet18", 4, device="cpu").state_dict()
    run = cli_est.main([
        "--data-path", coco_root, "--device", "cpu", "--LEHE_blur_seg",
        "--add_noise", "--add_block", "--add_jpeg_artefacts",
        "--quantize_image", "--resize_images", "--crop_images",
        "--label_smoothing", "0.1", "-b", "2", "--epochs", "1",
        "--early_stop", "1", "--print-freq", "1", "--lr", "0.01",
        "--output_dir", str(out), "--workers", "2"])
    assert run.state.step == 2 and len(run.losses) == 2
    assert all(np.isfinite(v) for m in run.losses for v in m.values())
    for k, v in run.state.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert not torch.equal(v, start[k]), k
    model = ResNetClassifier("resnet18", 4, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    state = restore_checkpoint(str(out / "model_0.pt"),
                               TrainState(0, model, opt))
    assert state.step == 2
    for k, v in run.state.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert model.body.bn1.num_batches_tracked.item() == 2.0


ESTIMATOR_REFUSALS = {
    # Its stored labels are LEHE classes, as JAX refuses it.
    "natural-dataset": (["--dataset", "GOPROBlurEst"], ValueError,
                        "LEHE_blur_seg"),
    "flag-not-read": (["--warp_in_model"], NotImplementedError,
                      "warp_in_model"),
    "missing-pretrained": (["--pretrained"], FileNotFoundError,
                           "resnet18_imagenet.pth"),
}


@pytest.mark.parametrize("case", sorted(ESTIMATOR_REFUSALS))
def test_estimator_cli_refusals(case, coco_root, tiny, tmp_path):
    """``--dataset GOPROBlurEst`` without ``--LEHE_blur_seg`` raises
    ValueError, as JAX exits; a common flag the estimator never reads
    raises NotImplementedError; a missing ``--pretrained`` file raises
    where JAX trains from scratch."""
    flags, exc, name = ESTIMATOR_REFUSALS[case]
    with pytest.raises(exc, match=name):
        cli_est.main(["--data-path", coco_root, "--device", "cpu",
                      "--output_dir", str(tmp_path), *flags])
