"""The single-map detectors and the natural-blur datasets through the
port's entry points, held against the JAX package's on the CPU:
``cli.evaluate --model mobile_net`` on a synthetic COCO and with
``--blurred_dataset GOPROSynth --expand_synth_boxes`` on a synthetic
GOPRO tree (JAX's 19 stats within 1e-3), ``cli.train --model mobile_net``
-> checkpoint -> ``cli.evaluate`` on ``--device cpu``, and
``cli.train_blur_estimator --dataset GOPROBlurEst --LEHE_blur_seg
--test_only`` against JAX's on a rendered set.

The detector is shrunk on both sides as ``tests/test_torch_port_cli.py``
shrinks the FPN one (96x96 model bucket, small RPN and NMS pools, 20
detections an image, 5 classes); MobileNetV2 keeps its full widths."""

import functools

import numpy as np
import pytest
import torch

from remedy_helpers import np_tree, resnet18_sd
from synthetic_gopro import write_gopro
from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from torso_weights import mobilenet_sd
from test_torch_port_cli import SIZES, bank, coco_root  # noqa: F401

import detectinblur_tpu.cli.dataset_tools as jax_tools
import detectinblur_tpu.cli.evaluate as jax_cli_eval
import detectinblur_tpu.cli.train_blur_estimator as jax_cli_est
import detectinblur_tpu.data.batching as jax_batching
import detectinblur_tpu.utils.torch_convert as jax_torch_convert
from detectinblur_tpu.models import backbones as jb
from detectinblur_tpu.models.roi_heads import BoxHeadConfig as JaxBoxHeadConfig
from detectinblur_tpu.models.rpn import RPNConfig as JaxRPNConfig
import detectinblur_tpu_torch.cli.dataset_tools as tools
import detectinblur_tpu_torch.cli.evaluate as cli_eval
import detectinblur_tpu_torch.cli.train as cli_train
import detectinblur_tpu_torch.cli.train_blur_estimator as cli_est
import detectinblur_tpu_torch.data.batching as batching
from detectinblur_tpu_torch.cli.args import bn_mode_for
from detectinblur_tpu_torch.models.backbones import (
    SingleMapConfig,
    SingleMapFasterRCNN,
)
from detectinblur_tpu_torch.models.roi_heads import BoxHeadConfig
from detectinblur_tpu_torch.models.rpn import RPNConfig
from detectinblur_tpu_torch.train.eval_loop import evaluate_coco
from detectinblur_tpu_torch.utils.convert import (
    classifier_from_torchvision,
    params_from_jax,
)

TINY = dict(min_size=96, max_size=96, num_classes=5)
TINY_RPN = dict(pre_nms_top_n_train=200, post_nms_top_n_train=100,
                pre_nms_top_n_test=200, post_nms_top_n_test=100)
TINY_BOX = dict(batch_size_per_image=64, nms_pool=256, detections_per_img=20)
TORSOS = {"mobile_net": "mobile_net", "resnet_50": "resnet50"}


class _JaxTiny(jb.SingleMapFasterRCNN):
    """JAX's single-map detector whose fresh box predictor is scaled x4,
    so that random weights score detections apart (the scores of JAX's
    Linear init all sit near 1/5)."""

    def init(self, key, bucket=(224, 224)):
        params = super().init(key, bucket)
        pred = params["box_predictor"]
        for k in ("cls_score", "bbox_pred"):
            pred[k]["kernel"] = pred[k]["kernel"] * 4
        return params


@pytest.fixture(scope="module")
def mobilenet_pth(tmp_path_factory):
    """A He-scaled torchvision mobilenet_v2 classifier, as a .pth."""
    sd = mobilenet_sd()
    path = tmp_path_factory.mktemp("w") / "mobilenet_v2.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def gopro_root(tmp_path_factory):
    """A synthetic GOPRO tree: two 13-frame sequences of 72x96 frames
    (GOPROSynth's window of 5 gives 3 centers each), boxes 40-90% of a
    side, so that random weights score some AP."""
    return write_gopro(str(tmp_path_factory.mktemp("gopro")),
                       [("train", 13), ("test", 13)], hw=(72, 96), seed=2,
                       box_frac=(0.4, 0.9))


@pytest.fixture
def tiny_single(monkeypatch, bank):
    """The tiny single-map detector, one 96x96 bucket and the injected PSF
    bank, on both sides."""
    def port_build(args, device):
        return SingleMapFasterRCNN(SingleMapConfig(
            TORSOS[args.model], rpn=RPNConfig(**TINY_RPN),
            box=BoxHeadConfig(**TINY_BOX), bn_mode=bn_mode_for(args),
            precision="highest", **TINY), device=device)

    def jax_build(args, bn_mode=None):
        return _JaxTiny(jb.SingleMapConfig(
            TORSOS[args.model], bn_mode=bn_mode, rpn=JaxRPNConfig(**TINY_RPN),
            box=JaxBoxHeadConfig(**TINY_BOX), **TINY))

    bucket = lambda hw, **kw: (96, 96)
    for mod in (cli_train, cli_eval, cli_est, jax_cli_eval, jax_cli_est):
        monkeypatch.setattr(mod, "generate_psf_bank", lambda *a, **k: bank)
    for mod in (cli_train, cli_eval, jax_cli_eval):
        monkeypatch.setattr(mod, "model_bucket_for_batch", bucket)
    for mod in (cli_train, cli_eval):
        monkeypatch.setattr(mod, "build_model", port_build)
    monkeypatch.setattr(jax_cli_eval, "build_model", jax_build)
    for mod in (cli_est, jax_cli_est):
        monkeypatch.setattr(mod, "model_bucket_for", lambda b: (96, 96))
    for mod in (batching, jax_batching):
        monkeypatch.setattr(mod, "DEFAULT_SOURCE_BUCKETS", ((96, 96),))
    return port_build, jax_build


def _port_checkpoint(jax_build, pth, path):
    """The weights JAX's ``cli.evaluate`` loads from ``pth`` (its torso,
    JAX's random heads, MobileNetV2's statistics with a count of 16), as
    a bare state dict of the port at ``path``."""
    args = cli_train.train_parser().parse_args(["--model", "mobile_net"])
    params, stats = jax_cli_eval.load_params(jax_build(args), pth,
                                             mode_one_n=16.0)
    torch.save(params_from_jax(np_tree(params), TINY["num_classes"],
                               np_tree(stats), backbone="mobile_net"), path)
    return str(path)


EVAL_CASES = {
    "coco": lambda roots: ["--data-path", roots["coco"], "--vanilla_eval"],
    "goprosynth-expanded": lambda roots: [
        "--data-path", roots["gopro"], "--blurred_dataset", "GOPROSynth",
        "--expand_synth_boxes"],
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluate_mobile_net_matches_jax(case, coco_root, gopro_root,
                                         mobilenet_pth, tiny_single, tmp_path,
                                         monkeypatch, capsys):
    """``cli.evaluate --model mobile_net`` of both packages with the same
    weights (JAX's from the .pth; the port's from their conversion): on
    the synthetic COCO, and on the GOPRO tree as GOPROSynth with the
    flow-expanded boxes (pre-blurred, source bucket 736x1312, its pseudo
    ground truth as the COCO index). The same 19 stats within 1e-3
    absolute and 1e-3 of each stat's size, with detections scored."""
    _, jax_build = tiny_single
    ckpt = _port_checkpoint(jax_build, mobilenet_pth, tmp_path / "m.pt")
    argv = EVAL_CASES[case]({"coco": coco_root, "gopro": gopro_root})
    argv += ["--model", "mobile_net", "--workers", "0"]
    loops = []

    def recorded(*args, **kwargs):
        stats, loop = evaluate_coco(*args, **kwargs)
        loops.append(loop)
        return stats, loop

    monkeypatch.setattr(cli_eval, "evaluate_coco", recorded)
    ours = cli_eval.main(argv + ["--device", "cpu", "--resume", ckpt])
    assert "model buckets met: 1 [(96, 96)]" in capsys.readouterr().out
    ref = np.asarray(jax_cli_eval.main(argv + ["--start_from_weights",
                                               mobilenet_pth]))
    assert ours.shape == ref.shape == (19,)
    assert ref[0] > 0 and ref[8] > 0.01, "no AP or AR to compare"
    np.testing.assert_allclose(ours, ref, atol=1e-3, rtol=0)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-7)
    n = len(SIZES["val2017"]) if case == "coco" else 6
    assert loops[0]["images"] == n


def test_train_checkpoint_then_evaluate_mobile_net(coco_root, mobilenet_pth,
                                                   tiny_single, tmp_path):
    """``cli.train --model mobile_net`` from the ImageNet .pth (its torso
    and running statistics, random heads) on --device cpu: finite losses,
    MobileNetV2's running statistics moved by the train-mode BatchNorms
    (2 steps counted), every parameter trained (nothing outside
    ``backbone.body`` is frozen); ``model_0.pt`` gives back weights and
    statistics bit for bit, and ``cli.evaluate --resume`` runs on it with
    the statistics and count it was saved with."""
    port_build, _ = tiny_single
    out = tmp_path / "out"
    run = cli_train.main([
        "--data-path", coco_root, "--device", "cpu", "--model", "mobile_net",
        "--start_from_weights", mobilenet_pth, "--blur_train",
        "--expand_target_boxes", "-b", "2", "--epochs", "1",
        "--early_stop", "2", "--output_dir", str(out), "--lr", "0.001",
        "--print-freq", "1", "--workers", "2"])
    assert len(run.losses) == 2 and run.state.step == 2
    assert all(np.isfinite(v) for m in run.losses for v in m.values())
    model = run.state.model
    trained = {id(p) for g in run.state.optimizer.param_groups
               for p in g["params"]}
    assert trained == {id(p) for p in model.parameters()}
    bn = model.backbone.block5.depthwise_bn
    assert bn.num_batches_tracked.item() == 2.0
    start = port_build(cli_train.train_parser().parse_args(
        ["--model", "mobile_net"]), "cpu")
    cli_train.load_initial_params(cli_train.train_parser().parse_args(
        ["--start_from_weights", mobilenet_pth]), start)
    assert not torch.equal(bn.running_mean,
                           start.backbone.block5.depthwise_bn.running_mean)
    saved = torch.load(out / "model_0.pt", weights_only=True)["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(saved[k], v), k

    models = []

    def recorded(eval_step, m, *args, **kwargs):
        models.append(m)
        return evaluate_coco(eval_step, m, *args, **kwargs)

    cli_eval.evaluate_coco, orig = recorded, cli_eval.evaluate_coco
    try:
        stats = cli_eval.main([
            "--data-path", coco_root, "--device", "cpu", "--model",
            "mobile_net", "--resume", str(out / "model_0.pt"),
            "--vanilla_eval", "--workers", "0", "--early_stop", "2"])
    finally:
        cli_eval.evaluate_coco = orig
    assert stats.shape == (19,) and np.isfinite(stats).all()
    assert torch.equal(models[0].backbone.block5.depthwise_bn.running_var,
                       bn.running_var)
    assert models[0].backbone.stem_bn.num_batches_tracked.item() == 2.0


def test_estimator_gopro_blur_est_matches_jax(gopro_root, tiny_single,
                                              tmp_path, monkeypatch, capsys):
    """``cli.train_blur_estimator --dataset GOPROBlurEst --LEHE_blur_seg
    --test_only`` of both packages from one resnet18 .pth (its fc on both
    sides) on a set rendered by the port's ``render-gopro-synth`` and
    split by ``segment-gopro``: the same top-1, top-2 and mean per-class
    accuracy (the printed line) and confusion matrix."""
    rendered = str(tmp_path / "rendered")
    tools.main(["render-gopro-synth", "--root_dir", gopro_root,
                "--output_dir", rendered, "--window", "2"])
    jax_tools.main(["segment-gopro", "--root_dir", rendered])
    sd = resnet18_sd(4, seed=3)
    path = tmp_path / "resnet18.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    monkeypatch.setattr(cli_est, "classifier_from_torchvision",
                        functools.partial(classifier_from_torchvision,
                                          include_fc=True))
    monkeypatch.setattr(
        jax_torch_convert, "convert_resnet_classifier_state_dict",
        functools.partial(jax_torch_convert.convert_resnet_classifier_state_dict,
                          include_fc=True))
    argv = ["--data-path", rendered, "--dataset", "GOPROBlurEst",
            "--LEHE_blur_seg", "--test_only", "--start_from_weights",
            str(path), "-b", "2", "--workers", "0"]
    ours = cli_est.main(argv + ["--device", "cpu",
                                "--output_dir", str(tmp_path / "ours")])
    printed = capsys.readouterr().out
    (tmp_path / "ref").mkdir()
    jax_cli_est.main(argv + ["--output_dir", str(tmp_path / "ref")])
    ref_printed = capsys.readouterr().out
    line = lambda out: next(l for l in out.splitlines() if l.startswith("Top1"))
    assert line(printed) == line(ref_printed)
    ref_cm = np.load(tmp_path / "ref" / "confusion_matrix.npy")
    np.testing.assert_array_equal(ours.confusion, ref_cm)
    assert ours.confusion.sum() == ref_cm.sum() > 0
