"""The port's entry points held against the JAX package on the CPU:
checkpoints, weight conversion, the unported flags, and the whole slice,
``cli.evaluate`` of both packages on one synthetic COCO with the same
weights and PSF bank, plus the port's train -> checkpoint -> evaluate.

The detector is shrunk on both sides as ``tests/test_cli_e2e.py``'s
``tiny_cli`` shrinks it (96x96 bucket, small RPN and NMS pools, 20
detections an image, 5 classes): the widths stay ResNet50-FPN's.
"""

import argparse
import json
import os

import jax
import numpy as np
import pytest
import torch

from remedy_helpers import resnet18_sd
from synthetic_coco import write_coco
from synthetic_torch import synthetic_deepdeblur_state_dict
from torch_reference import make_random_fasterrcnn_sd
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

import detectinblur_tpu.cli.evaluate as jax_cli_eval
import detectinblur_tpu.cli.train_blur_estimator as jax_cli_est
import detectinblur_tpu.data.batching as jax_batching
import detectinblur_tpu.utils.torch_convert as jax_torch_convert
from detectinblur_tpu.models.classifier import (
    ResNetClassifier as JaxResNetClassifier,
)
from detectinblur_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from detectinblur_tpu.models.faster_rcnn import (
    FasterRCNNConfig as JaxFasterRCNNConfig,
)
from detectinblur_tpu.models.roi_heads import BoxHeadConfig as JaxBoxHeadConfig
from detectinblur_tpu.models.rpn import RPNConfig as JaxRPNConfig
from detectinblur_tpu.utils.torch_convert import convert_fasterrcnn_state_dict
import detectinblur_tpu_torch.cli.evaluate as cli_eval
import detectinblur_tpu_torch.cli.train as cli_train
import detectinblur_tpu_torch.cli.train_blur_estimator as cli_est
import detectinblur_tpu_torch.data.batching as batching
from detectinblur_tpu_torch.cli.args import EVAL_ONLY, bn_mode_for
from detectinblur_tpu_torch.models.classifier import ResNetClassifier
from detectinblur_tpu_torch.models.faster_rcnn import (
    FasterRCNN,
    FasterRCNNConfig,
)
from detectinblur_tpu_torch.models.roi_heads import BoxHeadConfig
from detectinblur_tpu_torch.models.rpn import RPNConfig
from detectinblur_tpu_torch.train.eval_loop import evaluate_coco
from detectinblur_tpu_torch.utils.convert import (
    classifier_from_torchvision,
    load_torch_state_dict,
    params_from_jax,
    params_from_torchvision,
)

TINY = dict(min_size=96, max_size=96, num_classes=5)
TINY_RPN = dict(pre_nms_top_n_train=200, post_nms_top_n_train=100,
                pre_nms_top_n_test=200, post_nms_top_n_test=100)
TINY_BOX = dict(batch_size_per_image=64, nms_pool=256, detections_per_img=20)
SIZES = {"train2017": [(80, 96), (96, 72), (64, 96), (96, 96)],
         "val2017": [(80, 96), (96, 72), (64, 96), (96, 80), (72, 96),
                     (96, 64)]}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return write_coco(str(tmp_path_factory.mktemp("coco")), SIZES, seed=1,
                      n_cats=4, boxes=(2, 5), box_frac=(0.4, 0.9))


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """torchvision-layout random weights for 5 classes, as a .pth."""
    sd = make_random_fasterrcnn_sd(np.random.default_rng(0), num_classes=5)
    path = tmp_path_factory.mktemp("w") / "tiny.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def ensemble_files(tmp_path_factory):
    """Four specialist .pth files (the random weights of ``pth``, whose
    detections score, each with its box predictor moved by 5% noise from
    its own seed, so that each scores differently), the port's LEHE
    estimator checkpoint (a bare state dict, running statistics included)
    made from one resnet18 state dict, that state dict, and a DeepDeblur
    .pth (3 scales, 8 features, 2 blocks)."""
    d = tmp_path_factory.mktemp("ensemble")
    paths = []
    for seed in range(4):
        sd = make_random_fasterrcnn_sd(np.random.default_rng(0),
                                       num_classes=5)
        rng = np.random.default_rng(seed + 10)
        for k in ("roi_heads.box_predictor.cls_score.weight",
                  "roi_heads.box_predictor.bbox_pred.weight"):
            sd[k] = sd[k] * (1 + 0.05 * rng.standard_normal(
                sd[k].shape)).astype(np.float32)
        paths.append(str(d / f"specialist_{seed}.pth"))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, paths[-1])
    est_sd = resnet18_sd(4, seed=3)
    est = ResNetClassifier("resnet18", 4, "eval", precision="highest",
                           device="cpu")
    est.load_state_dict(classifier_from_torchvision(est_sd, num_classes=4,
                                                    include_fc=True))
    torch.save(est.state_dict(), d / "estimator.pt")
    deblur = {k: torch.from_numpy(v) for k, v in
              synthetic_deepdeblur_state_dict(3, 8, 2, seed=5).items()}
    torch.save(deblur, d / "deepdeblur.pth")
    return dict(paths=paths, estimator=str(d / "estimator.pt"),
                estimator_sd=est_sd, deblur=str(d / "deepdeblur.pth"))


@pytest.fixture(scope="module")
def bank():
    rng = np.random.default_rng(1)
    b = np.zeros((3, 5, 2, 128, 128), np.float32)
    b[:, :, :, 60:68, 60:68] = rng.random((3, 5, 2, 8, 8))
    return b


@pytest.fixture
def tiny(monkeypatch, bank):
    """The tiny detector (2 classes for --dataset coco_kp), one 96x96
    bucket and the injected PSF bank, on both sides."""
    def sized(args):
        """TINY, with 2 classes for --dataset coco_kp."""
        kp = getattr(args, "dataset", "coco") == "coco_kp"
        return dict(TINY, num_classes=2) if kp else TINY

    def port_build(args, device):
        return FasterRCNN(FasterRCNNConfig(
            **sized(args), rpn=RPNConfig(**TINY_RPN),
            box=BoxHeadConfig(**TINY_BOX),
            warp_internally=getattr(args, "warp_in_model", False),
            bn_mode=bn_mode_for(args), precision="highest"), device=device)

    def jax_build(args, bn_mode=None):
        return JaxFasterRCNN(JaxFasterRCNNConfig(
            **sized(args), bn_mode=bn_mode, rpn=JaxRPNConfig(**TINY_RPN),
            box=JaxBoxHeadConfig(**TINY_BOX),
            warp_internally=args.warp_in_model))

    bucket = lambda hw, **kw: (96, 96)
    for mod in (cli_train, cli_eval, cli_est):
        monkeypatch.setattr(mod, "generate_psf_bank", lambda *a, **k: bank)
    for mod in (cli_train, cli_eval):
        monkeypatch.setattr(mod, "build_model", port_build)
        monkeypatch.setattr(mod, "model_bucket_for_batch", bucket)
    monkeypatch.setattr(jax_cli_eval, "build_model", jax_build)
    monkeypatch.setattr(jax_cli_eval, "model_bucket_for_batch", bucket)
    monkeypatch.setattr(jax_cli_eval, "generate_psf_bank", lambda *a, **k: bank)
    monkeypatch.setattr(jax_cli_est, "generate_psf_bank", lambda *a, **k: bank)
    for mod in (cli_est, jax_cli_est):
        monkeypatch.setattr(mod, "model_bucket_for", lambda b: (96, 96))
    for mod in (batching, jax_batching):
        monkeypatch.setattr(mod, "DEFAULT_SOURCE_BUCKETS", ((96, 96),))
    return port_build


# ---------------------------------------------------------- the slice
EVAL_CASES = {
    "vanilla": ["--vanilla_eval"],
    "blur-expand": ["--blur_eval", "--param_index", "1",
                    "--expand_target_boxes"],
    # The deterministic remedies: the warp, the blur-conditional norms and
    # mode_one BatchNorm (statistics from the .pth, a count of 16); clean
    # images get the identity warp and ImageNet's norms.
    "remedies-clean": ["--vanilla_eval", "--warp_in_model",
                       "--use_custom_image_norm", "--mode_one_norm"],
    "remedies-blur": ["--blur_eval", "--param_index", "1", "--warp_in_model",
                      "--use_custom_image_norm", "--mode_one_norm"],
    # BatchNorm on each image's own statistics (batch 1).
    "unfrozen-blur": ["--blur_eval", "--param_index", "2",
                      "--expand_target_boxes", "--unfrozen_batch_norm"],
    # The LEHE ensemble of four specialists, gated by the estimator, after
    # deblur-first (the files come from ``ensemble_files``).
    "ensemble-lehe-deblur": ["--vanilla_eval", "--use_ensemble", "--LEHE",
                             "--deblur_first"],
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluate_cli_matches_jax(coco_root, pth, tiny, case, monkeypatch,
                                  capsys, request):
    """The port's and JAX's ``cli.evaluate.main`` on the same synthetic
    COCO, weights and PSF bank: the same 19 stats within 1e-3 absolute,
    for the clean eval and for each of a blur sweep's 5 cells with the
    expanded-GT rewrite, under the deterministic remedies (warp,
    blur-conditional norms, mode_one and train-mode BatchNorm), and for
    the LEHE ensemble after deblur-first (JAX's estimator built from the
    state dict the port's checkpoint holds). Random weights score AP near
    1e-3 (AR100 0.03-0.15), so each stat is also held within 1e-3 of its
    own size."""
    argv = ["--data-path", coco_root, "--workers", "2", *EVAL_CASES[case]]
    if "--use_ensemble" in argv:
        files = request.getfixturevalue("ensemble_files")
        argv += ["--ensemble_model_paths", *files["paths"],
                 "--blur_estimator_path", files["estimator"],
                 "--deblurer_model_location", files["deblur"]]
        params, stats = jax_torch_convert.convert_resnet_classifier_state_dict(
            files["estimator_sd"], include_fc=True)
        monkeypatch.setattr(jax_cli_eval, "load_estimator", lambda path, n: (
            JaxResNetClassifier("resnet18", n, bn_mode="eval"),
            {"params": params, "batch_stats": stats}))
    else:
        argv += ["--start_from_weights", pth]
    loops = []

    def recorded(*args, **kwargs):
        stats, loop = evaluate_coco(*args, **kwargs)
        loops.append(loop)
        return stats, loop

    monkeypatch.setattr(cli_eval, "evaluate_coco", recorded)
    ours = cli_eval.main(argv + ["--device", "cpu"])
    printed = capsys.readouterr().out
    ref = jax_cli_eval.main(argv)
    clean = "--vanilla_eval" in EVAL_CASES[case]
    if clean:
        ours, ref = {0: ours}, {0: ref}
    assert sorted(ours) == sorted(ref)
    assert len(ours) == (1 if clean else 5)
    for k in ref:
        assert ours[k].shape == (19,)
        r = np.asarray(ref[k])
        assert r[0] > 0 and r[8] > 0.01, "no AP or AR to compare"
        np.testing.assert_allclose(ours[k], r, atol=1e-3, rtol=0,
                                   err_msg=str(k))
        np.testing.assert_allclose(ours[k], r, rtol=1e-3, atol=1e-7,
                                   err_msg=str(k))
    n_val = len(SIZES["val2017"])
    assert [s["images"] for s in loops] == [n_val] * len(ours)
    assert printed.count("model buckets met: 1 [(96, 96)]") == len(ours)
    assert all(s["step_ms_per_image"] is None for s in loops)
    if "--use_ensemble" in argv:
        assert printed.count("ensemble specialists chosen") == len(ours)


def test_train_checkpoint_then_evaluate(coco_root, tiny, tmp_path):
    """The port's train CLI (blurred, expanded GT, eval before and after)
    writes model_0.pt and args_0.json; restore_checkpoint gives back the
    weights, momentum buffers and step bit for bit; cli.evaluate --resume
    runs on that file. All on --device cpu."""
    from detectinblur_tpu_torch.train.checkpoint import (
        latest_epoch,
        restore_checkpoint,
    )
    from detectinblur_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )

    out = tmp_path / "out"
    run = cli_train.main([
        "--data-path", coco_root, "--device", "cpu", "--blur_train",
        "--expand_target_boxes", "-b", "2", "--epochs", "1",
        "--early_stop", "2", "--output_dir", str(out), "--lr", "0.001",
        "--print-freq", "1", "--eval_first", "--workers", "2"])
    assert len(run.losses) == 2 and run.state.step == 2
    assert all(np.isfinite(v) for m in run.losses for v in m.values())
    assert sorted(run.evals) == ["Blurred/-1", "Blurred/0", "Normal/-1",
                                 "Normal/0"]
    assert latest_epoch(str(out)) == 0
    assert json.load(open(out / "args_0.json"))["expand_target_boxes"] is True

    model = tiny(None, "cpu")
    opt, _ = make_optimizer(model, base_lr=0.001)
    state = restore_checkpoint(str(out / "model_0.pt"),
                               create_train_state(model, opt))
    assert state.step == run.state.step
    for (name, p), q in zip(model.state_dict().items(),
                            run.state.model.state_dict().values()):
        assert torch.equal(p, q), name
    got = [opt.state[p]["momentum_buffer"] for g in opt.param_groups
           for p in g["params"]]
    want = [run.state.optimizer.state[p]["momentum_buffer"]
            for g in run.state.optimizer.param_groups for p in g["params"]]
    assert len(got) == len(want) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    stats = cli_eval.main(["--data-path", coco_root, "--device", "cpu",
                           "--resume", str(out / "model_0.pt"),
                           "--vanilla_eval", "--workers", "0",
                           "--early_stop", "2"])
    assert stats.shape == (19,) and np.isfinite(stats).all()


def test_train_and_evaluate_with_every_remedy(coco_root, tiny, tmp_path,
                                              monkeypatch, capsys):
    """cli.train with every train-time remedy (AugMix, blur, noise, block,
    JPEG, the warp, the norms, train-mode BatchNorm) on --device cpu: the
    losses stay finite, the running statistics move and come back bit for
    bit from model_0.pt with their count of 2 steps. cli.evaluate
    --mode_one_norm on that checkpoint keeps its count (a .pth would get
    16), with every eval-time remedy: dilation and the corruptions too.
    A FrozenBatchNorm checkpoint evaluated with --mode_one_norm starts
    from fresh statistics, as JAX's restore_subtree does."""
    out = tmp_path / "out"
    remedies = ["--warp_in_model", "--use_custom_image_norm",
                "--add_noise", "--add_block", "--add_jpeg_artefacts"]
    run = cli_train.main([
        "--data-path", coco_root, "--device", "cpu", "--blur_train",
        "--unfrozen_batch_norm", "--non_pos_aug_mix", *remedies, "-b", "2",
        "--epochs", "1", "--early_stop", "2", "--output_dir", str(out),
        "--lr", "0.001", "--print-freq", "1", "--workers", "2"])
    assert len(run.losses) == 2 and run.state.step == 2
    assert all(np.isfinite(v) for m in run.losses for v in m.values())
    bn = run.state.model.backbone.body.layer2_0.bn1
    assert bn.num_batches_tracked.item() == 2.0
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    saved = torch.load(out / "model_0.pt", weights_only=True)["model"]
    for k, v in run.state.model.state_dict().items():
        assert torch.equal(saved[k], v), k

    models = []

    def recorded(eval_step, model, *args, **kwargs):
        models.append(model)
        return evaluate_coco(eval_step, model, *args, **kwargs)

    monkeypatch.setattr(cli_eval, "evaluate_coco", recorded)
    stats = cli_eval.main([
        "--data-path", coco_root, "--device", "cpu", "--resume",
        str(out / "model_0.pt"), "--blur_eval", "--param_index", "1",
        "--mode_one_norm", "--dilate_psf", *remedies, "--workers", "0",
        "--early_stop", "2"])
    assert len(stats) == 5 and all(np.isfinite(v).all() for v in stats.values())
    assert models[0].cfg.bn_mode == "mode_one"
    assert torch.equal(models[0].backbone.body.layer2_0.bn1.running_var,
                       bn.running_var)
    assert models[0].backbone.body.bn1.num_batches_tracked.item() == 2.0

    frozen = tmp_path / "frozen.pt"
    torch.save(tiny(None, "cpu").state_dict(), frozen)
    capsys.readouterr()
    cli_eval.main(["--data-path", coco_root, "--device", "cpu", "--resume",
                   str(frozen), "--vanilla_eval", "--mode_one_norm",
                   "--workers", "0", "--early_stop", "1"])
    assert "holds no BatchNorm statistics" in capsys.readouterr().out
    assert models[-1].backbone.body.bn1.num_batches_tracked.item() == 0.0


# ----------------------------------------------------- weights and files
def _new_spelling(sd):
    """torchvision's newer key names for the FPN and the RPN conv."""
    out = {}
    for k, v in sd.items():
        for old, new in ((".inner_blocks.", ".inner_blocks.{}.0."),
                         (".layer_blocks.", ".layer_blocks.{}.0.")):
            if old in k:
                head, rest = k.split(old)
                i, leaf = rest.split(".", 1)
                k = head + new.format(i) + leaf
        k = k.replace("rpn.head.conv.", "rpn.head.conv.0.0.")
        out[k] = v
    return out


@pytest.mark.parametrize("spelling", ["old", "new"])
def test_params_from_torchvision_equals_jax_route(spelling):
    """Bit for bit what the JAX converter plus params_from_jax give, in
    both torchvision key spellings, from tensors or numpy arrays."""
    sd = make_random_fasterrcnn_sd(np.random.default_rng(0), num_classes=5)
    src = _new_spelling(sd) if spelling == "new" else sd
    if spelling == "new":
        assert "backbone.fpn.inner_blocks.2.0.weight" in src
        assert "rpn.head.conv.0.0.bias" in src
    ref = params_from_jax(_np_tree(convert_fasterrcnn_state_dict(src)),
                          num_classes=5)
    for given in (src, {k: torch.from_numpy(v) for k, v in src.items()}):
        ours = params_from_torchvision(given, num_classes=5)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == torch.float32
            assert torch.equal(ours[k], ref[k]), k


def test_params_from_torchvision_is_strict():
    sd = make_random_fasterrcnn_sd(np.random.default_rng(0), num_classes=5)
    with pytest.raises(ValueError):   # 5-class weights for a 91-class model
        params_from_torchvision(sd)
    cut = dict(sd)
    del cut["roi_heads.box_head.fc7.bias"]
    with pytest.raises(KeyError, match="fc7"):
        params_from_torchvision(cut, num_classes=5)
    with pytest.raises(KeyError, match="extra"):
        params_from_torchvision(dict(sd, **{"rpn.head.extra.weight":
                                            np.zeros(3, np.float32)}), 5)


def test_load_torch_state_dict_layouts(tmp_path):
    """A bare state dict, and the reference's checkpoint layout with its
    argparse args (read under weights_only)."""
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3), "b.bias": torch.ones(2)}
    torch.save(sd, tmp_path / "bare.pth")
    torch.save({"model": sd, "optimizer": {}, "lr_scheduler": {},
                "args": argparse.Namespace(lr=0.02), "epoch": 3},
               tmp_path / "ref.pth")
    for name in ("bare.pth", "ref.pth"):
        got = load_torch_state_dict(str(tmp_path / name))
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], sd[k]) for k in sd)


class _Toy(torch.nn.Module):
    def __init__(self, width=3):
        super().__init__()
        self.fc = torch.nn.Linear(width, 2)
        self.register_buffer("scale", torch.ones(2))


def _toy_state(width=3, seed=0):
    from detectinblur_tpu_torch.train.state import TrainState

    torch.manual_seed(seed)
    model = _Toy(width)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return TrainState(0, model, opt)


def test_checkpoint_round_trip_and_strict_failures(tmp_path):
    from detectinblur_tpu_torch.train.checkpoint import (
        restore_checkpoint,
        restore_weights,
        save_checkpoint,
    )

    st = _toy_state()
    for _ in range(3):
        st.optimizer.zero_grad()
        st.model.fc(torch.randn(4, 3)).pow(2).sum().backward()
        st.optimizer.step()
    st = st._replace(step=3)
    path = save_checkpoint(str(tmp_path), st, epoch=2, args={"lr": 0.1})
    assert os.path.basename(path) == "model_2.pt"

    fresh = _toy_state(seed=1)
    got = restore_checkpoint(path, fresh)
    assert got.step == 3
    for a, b in zip(got.model.state_dict().values(), st.model.state_dict().values()):
        assert torch.equal(a, b)
    for p, q in zip(got.model.parameters(), st.model.parameters()):
        assert torch.equal(got.optimizer.state[p]["momentum_buffer"],
                           st.optimizer.state[q]["momentum_buffer"])
    weights_only = restore_weights(path, _toy_state(seed=2).model)
    assert torch.equal(weights_only.fc.weight, st.model.fc.weight)

    bare = tmp_path / "bare.pt"
    torch.save(st.model.state_dict(), bare)
    assert torch.equal(restore_weights(str(bare), _Toy()).fc.bias,
                       st.model.fc.bias)
    with pytest.raises(KeyError, match="not a full checkpoint"):
        restore_checkpoint(str(bare), _toy_state())       # resume of a bare file
    with pytest.raises(ValueError, match="shape"):
        restore_weights(path, _Toy(width=4))               # wrong shape
    extra = dict(st.model.state_dict(), stray=torch.zeros(1))
    torch.save(extra, tmp_path / "extra.pt")
    with pytest.raises(KeyError, match="stray"):
        restore_weights(str(tmp_path / "extra.pt"), _Toy())   # unexpected key
    missing = {"fc.weight": st.model.fc.weight}
    torch.save(missing, tmp_path / "missing.pt")
    with pytest.raises(KeyError, match="fc.bias"):
        restore_weights(str(tmp_path / "missing.pt"), _Toy())  # missing key
    ckpt = torch.load(path, weights_only=True)
    ckpt["optimizer"]["state"][0]["momentum_buffer"] = torch.zeros(3)
    torch.save(ckpt, tmp_path / "bad_momentum.pt")
    with pytest.raises(ValueError, match="momentum"):
        restore_checkpoint(str(tmp_path / "bad_momentum.pt"), _toy_state())


# ------------------------------------------------------- flags and device
REFUSED = [[f"--{f}"] for f in EVAL_ONLY
           if f not in ("deblurer_model_location", "ensemble_model_paths",
                        "blur_estimator_path", "image_output_dir",
                        "blurred_dataset")]
REFUSED += [["--deblurer_model_location", "d.pth"],
            ["--ensemble_model_paths", "a", "b", "c", "d"],
            ["--blur_estimator_path", "e"], ["--image_output_dir", "o"],
            ["--blurred_dataset", "GOPRO"], ["--world-size", "2"]]


# ``--world-size`` > 1 is ported: without the launcher's environment it
# raises, naming the launch command.
RAISES = {"--world-size": (RuntimeError, "torchrun --nproc_per_node 2")}


@pytest.mark.parametrize("flag", REFUSED, ids=lambda f: f[0])
def test_unported_flag_raises(flag, tmp_path):
    """Each flag the port does not have yet raises NotImplementedError
    naming it, in both CLIs, before any work starts. The flags of
    deblur-first, of the ensemble, of the natural-blur datasets and
    ``--image_output_dir`` (``EVAL_ONLY``) are ported in ``cli.evaluate``;
    ``cli.train``, which never reads them, still raises. ``--world-size
    2`` without ``torchrun`` raises ``RAISES``' error in both."""
    name = flag[0]
    error, match = RAISES.get(name, (NotImplementedError, name))
    for mod in (cli_eval, cli_train):
        if name in ("--dilate_psf", "--mode_one_norm") and mod is cli_train:
            continue    # evaluate-only flags
        if name.lstrip("-") in EVAL_ONLY and mod is cli_eval:
            continue    # ported in cli.evaluate
        with pytest.raises(error, match=match):
            mod.main(["--data-path", str(tmp_path), "--device", "cpu", *flag])


@pytest.mark.parametrize("model,torso,has_bn", [
    ("mobile_net", "mobile_net", True), ("resnet_50", "resnet50", False)])
def test_model_flag_builds_the_single_map_detector(model, torso, has_bn):
    """``--model mobile_net|resnet_50`` passes both CLIs' flag check and
    builds JAX's single-map detector (train.py:218-230 of the reference):
    the torso, 91 classes, min 300 / max 500; MobileNetV2's BatchNorms on
    running statistics, the resnet's FrozenBatchNorm (``has_bn`` False)
    unless a BatchNorm flag asks for a mode."""
    from detectinblur_tpu_torch.cli.args import eval_parser, refuse_unported
    from detectinblur_tpu_torch.models.backbones import SingleMapFasterRCNN

    for parser in (cli_train.train_parser(), eval_parser()):
        refuse_unported(parser, parser.parse_args(["--model", model]),
                        not_read=EVAL_ONLY)
    args = cli_train.train_parser().parse_args(["--model", model])
    m = cli_train.build_model(args, "meta")
    assert isinstance(m, SingleMapFasterRCNN)
    assert (m.cfg.backbone, m.cfg.num_classes, m.cfg.min_size,
            m.cfg.max_size, m.has_bn) == (torso, 91, 300, 500, has_bn)
    args = cli_train.train_parser().parse_args(["--model", model,
                                                "--unfrozen_batch_norm"])
    assert cli_train.build_model(args, "meta").has_bn


REFERENCE_FAULTS = {
    # JAX evaluates without deblurring and says nothing.
    "deblur-without-model": (["--deblur_first"], "deblurer_model_location"),
    "model-without-deblur": (["--deblurer_model_location", "d.pth"],
                             "deblur_first"),
    # JAX fails on an assert in predict (no bn_stats).
    "ensemble-mode-one": (["--use_ensemble", "--mode_one_norm",
                           "--ensemble_model_paths", "a", "b", "c", "d"],
                          "mode_one_norm"),
    "ensemble-unfrozen": (["--use_ensemble", "--unfrozen_batch_norm",
                           "--ensemble_model_paths", "a", "b", "c", "d"],
                          "unfrozen_batch_norm"),
    # JAX asserts (dropped under python -O).
    "ensemble-three-paths": (["--use_ensemble", "--ensemble_model_paths",
                              "a", "b", "c"], "four"),
    "ensemble-flags-alone": (["--LEHE", "--blur_estimator_path", "e"],
                             "need --use_ensemble"),
    # JAX ignores the flag on every other set.
    "synth-boxes-without-goprosynth": (
        ["--blurred_dataset", "GOPRO", "--expand_synth_boxes"],
        "expand_synth_boxes"),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_FAULTS))
def test_evaluate_refuses_what_jax_gets_wrong(case, tmp_path):
    """The flag combinations the JAX CLI evaluates wrongly or fails on
    raise ValueError naming the flag, before any file is read."""
    flags, name = REFERENCE_FAULTS[case]
    with pytest.raises(ValueError, match=name):
        cli_eval.main(["--data-path", str(tmp_path), "--device", "cpu",
                       *flags])


def test_clis_default_to_cuda(tmp_path):
    """Without --device the CLIs want CUDA and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for mod in (cli_eval, cli_train):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(["--data-path", str(tmp_path)])
