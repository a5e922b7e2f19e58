"""``--dataset coco_kp`` and ``--image_output_dir`` held against the JAX
package on the CPU: ``cli.evaluate`` of both packages on one synthetic
person-keypoint COCO with the same 2-class weights (19 stats within
1e-3), the port's train -> checkpoint -> evaluate on it, the class-count
check, the order of ``--blurred_dataset`` and ``--dataset``, and the
overlays: pixel for pixel JAX's drawing on a float image, where JAX's
binarizes a uint8 one.

The detector is ``test_torch_port_cli.py``'s ``tiny`` one (96x96 bucket,
small pools), with 2 classes for ``coco_kp``.
"""

import json
import os

import flax
import numpy as np
import pytest
import torch
from PIL import Image

from synthetic_coco import write_coco_kp
from test_torch_port_cli import SIZES, bank, tiny  # noqa: F401 (fixtures)
from torch_reference import make_random_fasterrcnn_sd
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

import detectinblur_tpu.cli.evaluate as jax_cli_eval
import detectinblur_tpu.data.natural_datasets as jax_natural
from detectinblur_tpu.utils import visualization as jax_viz
import detectinblur_tpu_torch.cli.evaluate as cli_eval
import detectinblur_tpu_torch.cli.train as cli_train
from detectinblur_tpu_torch.train import eval_loop
from detectinblur_tpu_torch.utils import visualization as viz


@pytest.fixture(scope="module")
def kp_root(tmp_path_factory):
    return write_coco_kp(str(tmp_path_factory.mktemp("coco_kp")), SIZES,
                         seed=1, persons=(1, 3), box_frac=(0.4, 0.9))


def _pth(tmp_path_factory, num_classes):
    sd = make_random_fasterrcnn_sd(np.random.default_rng(0),
                                   num_classes=num_classes)
    path = tmp_path_factory.mktemp("w") / f"tiny_{num_classes}.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def pth2(tmp_path_factory):
    """torchvision-layout random weights for 2 classes, as a .pth."""
    return _pth(tmp_path_factory, 2)


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGB"))


def test_evaluate_coco_kp_matches_jax(kp_root, pth2, tiny, tmp_path,
                                      monkeypatch):
    """``cli.evaluate --dataset coco_kp --image_output_dir`` of both
    packages on the same person-keypoint COCO, 2-class weights and
    images: JAX's 19 stats within 1e-3 absolute and 1e-3 of each stat
    (random weights score AP near 1e-2), and a PNG per image with JAX's
    names. Each of the port's PNGs is JAX's ``overlay_boxes`` of the
    port's detections on the source canvas (as a float image) pixel for
    pixel; JAX's own are binarized."""
    argv = ["--data-path", kp_root, "--workers", "2", "--dataset", "coco_kp",
            "--vanilla_eval", "--start_from_weights", pth2]
    drawn = []

    def recorded(output_dir, image_id, image, dets, index=0):
        drawn.append((image_id, image.copy(), [t[index].numpy() for t in dets]))
        return viz.dump_detections(output_dir, image_id, image, dets, index)

    monkeypatch.setattr(eval_loop, "dump_detections", recorded)
    ours = cli_eval.main(argv + ["--device", "cpu", "--image_output_dir",
                                 str(tmp_path / "ours")])
    ref = np.asarray(jax_cli_eval.main(argv + ["--image_output_dir",
                                               str(tmp_path / "jax")]))
    assert ours.shape == (19,)
    assert ref[0] > 0 and ref[8] > 0.01, "no AP or AR to compare"
    np.testing.assert_allclose(ours, ref, atol=1e-3, rtol=0)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-7)

    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == len(drawn) == len(SIZES["val2017"])
    for image_id, canvas, (boxes, scores, labels, valid) in drawn:
        assert canvas.dtype == np.uint8 and canvas.shape == (96, 96, 3)
        assert set(labels[valid].tolist()) <= {1}
        got = _pixels(tmp_path / "ours" / f"det_{image_id}.png")
        want = np.asarray(jax_viz.overlay_boxes(
            canvas / 255.0, boxes, labels, scores, valid))
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got)) > 2
        binarized = _pixels(tmp_path / "jax" / f"det_{image_id}.png")
        undrawn = (got == canvas).all(-1)
        assert np.isin(binarized[undrawn], (0, 255)).all()


def test_train_coco_kp_checkpoint_then_evaluate(kp_root, pth2, tiny,
                                                tmp_path):
    """``cli.train --dataset coco_kp`` (2 classes, from the 2-class .pth,
    blurred, a clean and a blurred eval after) writes model_0.pt, whose
    weights, momentum and step come back bit for bit; ``cli.evaluate
    --dataset coco_kp --resume`` on it gives 19 finite stats. All on
    --device cpu."""
    from detectinblur_tpu_torch.train.checkpoint import restore_checkpoint
    from detectinblur_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )

    out = tmp_path / "out"
    run = cli_train.main([
        "--data-path", kp_root, "--dataset", "coco_kp", "--device", "cpu",
        "--blur_train", "-b", "2", "--epochs", "1", "--early_stop", "2",
        "--output_dir", str(out), "--lr", "0.001", "--print-freq", "1",
        "--workers", "2", "--start_from_weights", pth2])
    assert len(run.losses) == 2 and run.state.step == 2
    assert all(np.isfinite(v) for m in run.losses for v in m.values())
    assert sorted(run.evals) == ["Blurred/0", "Normal/0"]
    assert run.state.model.cfg.num_classes == 2
    assert json.load(open(out / "args_0.json"))["dataset"] == "coco_kp"

    args = cli_train.train_parser().parse_args(["--dataset", "coco_kp"])
    model = tiny(args, "cpu")
    opt, _ = make_optimizer(model, base_lr=0.001)
    state = restore_checkpoint(str(out / "model_0.pt"),
                               create_train_state(model, opt))
    assert state.step == run.state.step
    for (name, p), q in zip(model.state_dict().items(),
                            run.state.model.state_dict().values()):
        assert torch.equal(p, q), name
    bufs = lambda o: [o.state[p]["momentum_buffer"] for g in o.param_groups
                      for p in g["params"]]
    assert len(bufs(opt)) == len(bufs(run.state.optimizer)) > 0
    assert all(torch.equal(a, b) for a, b in
               zip(bufs(opt), bufs(run.state.optimizer)))

    stats = cli_eval.main(["--data-path", kp_root, "--dataset", "coco_kp",
                           "--device", "cpu", "--resume",
                           str(out / "model_0.pt"), "--vanilla_eval",
                           "--workers", "0"])
    assert stats.shape == (19,) and np.isfinite(stats).all()


def test_class_count_mismatch_raises(kp_root, tiny, tmp_path_factory):
    """A 5-class detector .pth on the 2-class ``coco_kp`` model: JAX loads
    it and fails at its first step, in Flax's parameter shape check; both
    of the port's CLIs raise ValueError naming both counts when they load
    the file, before the first step (the model has 91 with --dataset
    coco)."""
    pth5 = _pth(tmp_path_factory, 5)
    argv = ["--data-path", kp_root, "--dataset", "coco_kp", "--workers", "0",
            "--vanilla_eval", "--start_from_weights", pth5]
    with pytest.raises(flax.errors.ScopeParamShapeError):
        jax_cli_eval.main(argv)
    with pytest.raises(ValueError, match="5-class box predictor; the model "
                                         "has 2 classes"):
        cli_eval.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match="5-class .*has 2 classes"):
        cli_train.main(["--data-path", kp_root, "--dataset", "coco_kp",
                        "--device", "cpu", "--start_from_weights", pth5])
    assert cli_train.num_classes_for(
        cli_train.train_parser().parse_args([])) == 91


def test_blurred_dataset_wins_over_coco_kp(pth2, tiny, monkeypatch):
    """With both flags, each package evaluates the natural-blur set and
    never opens the COCO split (JAX's evaluate.py reads --blurred_dataset
    first)."""
    class Opened(Exception):
        pass

    def natural(name, root, **kw):
        raise Opened(name)

    def coco(*a, **k):
        raise AssertionError("opened the COCO split")

    argv = ["--data-path", "unused", "--dataset", "coco_kp",
            "--blurred_dataset", "GOPRO", "--start_from_weights", pth2]
    monkeypatch.setattr(cli_eval, "get_natural_dataset", natural)
    monkeypatch.setattr(cli_eval, "get_datasets", coco)
    monkeypatch.setattr(jax_natural, "get_natural_dataset", natural)
    with pytest.raises(Opened, match="GOPRO"):
        cli_eval.main(argv + ["--device", "cpu"])
    with pytest.raises(Opened, match="GOPRO"):
        jax_cli_eval.main(argv)


def test_overlay_matches_jax_on_float_and_keeps_uint8():
    """On a float image (values past [0, 1] too) the port's overlay is
    JAX's pixel for pixel: boxes in their class colours, two pixels wide,
    the label and score, invalid and low-scoring detections skipped. On a
    uint8 image of 200 distinct values JAX's comes out binarized ({0, 255}
    off the drawing); the port's is JAX's drawing on that image as a
    float, so the image is kept."""
    rng = np.random.default_rng(0)
    image = rng.uniform(-0.2, 1.2, (60, 80, 3)).astype(np.float32)
    boxes = np.array([[5, 6, 40, 30], [20, 10, 70, 55], [0, 0, 79, 59],
                      [30, 30, 35, 36]], np.float32)
    labels = np.array([1, 7, 23, 1])
    scores = np.array([0.9, 0.6, 0.3, 0.75], np.float32)
    valid = np.array([True, True, True, False])
    for kw in ({}, {"scores": scores}, {"scores": scores, "valid": valid}):
        got = np.asarray(viz.overlay_boxes(image, boxes, labels, **kw))
        want = np.asarray(jax_viz.overlay_boxes(image, boxes, labels, **kw))
        np.testing.assert_array_equal(got, want)
    assert [viz.unique_color(t) for t in range(100)] == [
        jax_viz.unique_color(t) for t in range(100)]

    u8 = (np.arange(60 * 80 * 3) % 200).astype(np.uint8).reshape(60, 80, 3)
    assert len(np.unique(u8)) == 200
    binarized = np.asarray(jax_viz.overlay_boxes(u8, boxes[:0], labels[:0]))
    np.testing.assert_array_equal(np.unique(binarized), [0, 255])
    np.testing.assert_array_equal(
        np.asarray(viz.overlay_boxes(u8, boxes[:0], labels[:0])), u8)
    got = np.asarray(viz.overlay_boxes(u8, boxes, labels, scores, valid))
    np.testing.assert_array_equal(got, np.asarray(jax_viz.overlay_boxes(
        u8 / 255.0, boxes, labels, scores, valid)))
    assert len(np.unique(got)) > 200
