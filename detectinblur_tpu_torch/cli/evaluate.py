"""Evaluation entry point.

    python -m detectinblur_tpu_torch.cli.evaluate --data-path /data/coco \\
        --resume model_36.pt --blur_eval [--param_index 1] [--device cpu]

Port of ``detectinblur_tpu/cli/evaluate.py`` (evaluate.py of the
reference): on ``--dataset coco`` or ``coco_kp`` (the person-keypoint
annotations, 2 classes, bbox stats), one clean COCO val eval
(``--vanilla_eval``, or without
``--blur_eval``), or the synthetic blur sweep, EVAL_PARAMS[1:] x
EVAL_FRACTIONS[1:] with every image blurred (evaluate.py:299-370), from a
generated or a stored PSF bank, optionally with the expanded-GT rewrite
(``--expand_target_boxes``). Each eval is batch 1 with the image's own
model bucket. The in-detector remedies follow their flags:
``--warp_in_model``, ``--use_custom_image_norm``, ``--mode_one_norm`` and
``--unfrozen_batch_norm`` (the backbone's BatchNorms in ``mode_one`` or
``train`` mode), ``--dilate_psf`` and the corruptions ``--add_noise``,
``--add_block`` and ``--add_jpeg_artefacts``, their draws from a
generator seeded per iteration by the eval loop. ``--deblur_first`` with
``--deblurer_model_location`` (a DeepDeblur ``.pth``) runs the MSResNet on
each image after the blur and the corruptions. ``--use_ensemble`` with four
``--ensemble_model_paths`` evaluates the estimator-gated specialist
ensemble: the ``--blur_estimator_path`` checkpoint of
``cli.train_blur_estimator`` (4 classes with ``--LEHE``, else 16) picks a
specialist per image, or, without it, the true blur struct does.

``--model mobile_net`` / ``resnet_50`` evaluate the single-map detectors
(``models/backbones.py``); their ``.pth`` is an ImageNet classifier's
torso (MobileNetV2's running statistics with a count of 16), the heads
stay random, as in JAX. ``--blurred_dataset`` evaluates a natural-blur
set (``data/natural_datasets.py``: GOPRO, GOPROSynth, GOPROSynthLoad,
REDS, RealBlur, VidBlur) instead of COCO: batch 1 in the source bucket
736x1312, no synthetic blur, every remedy the flags ask for, against a
COCO index built from the set's pseudo ground truth;
``--expand_synth_boxes`` walks GOPROSynth's boxes through its optical
flow; ``--blurred_dataset`` wins over ``--dataset``, as in JAX.
``--image_output_dir`` writes the first 50 images of each eval with their
detections drawn (``utils/visualization.py``).

Refused with ``ValueError``, where the JAX CLI goes wrong: ``--deblur_first``
without a model path (JAX evaluates without deblurring) or a path without
the flag; ``--use_ensemble`` with ``--mode_one_norm`` or
``--unfrozen_batch_norm`` (JAX fails on an assert), without exactly four
paths (an ``assert`` in JAX), or with ``--resume`` /
``--start_from_weights``; the ensemble's flags without ``--use_ensemble``;
``--expand_synth_boxes`` without ``--blurred_dataset GOPROSynth`` (JAX
ignores it).

Under ``torchrun --nproc_per_node N`` each process evaluates its shard of
the images with the whole model (no DDP: nothing trains), and the
detections are merged across the processes before COCOeval
(``train/eval_loop.py``): a clean eval gives the stats of one process. The
eval loop seeds each image's draws with the process index, as JAX folds
it into its keys, so a blurred or corrupted eval draws other values than
in one process.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from detectinblur_tpu_torch.cli.args import eval_parser, refuse_unported
from detectinblur_tpu_torch.cli.train import (
    BLUR_STAT_TAGS,
    build_model,
    check_class_count,
    get_datasets,
)
from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
from detectinblur_tpu_torch.data.blur_sampling import (
    BlurPolicy,
    generate_psf_bank,
    load_psf_bank,
)
from detectinblur_tpu_torch.data.loader import DetectionLoader
from detectinblur_tpu_torch.data.natural_datasets import get_natural_dataset
from detectinblur_tpu_torch.ops.psf import EVAL_FRACTIONS, EVAL_PARAMS
from detectinblur_tpu_torch.parallel.dist import (
    process_count,
    process_group,
    process_index,
)
from detectinblur_tpu_torch.models.backbones import SingleMapFasterRCNN
from detectinblur_tpu_torch.models.classifier import ResNetClassifier
from detectinblur_tpu_torch.models.deblur import MSResNet
from detectinblur_tpu_torch.models.ensemble import (
    make_ensemble_predict,
    stack_specialists,
)
from detectinblur_tpu_torch.train.checkpoint import restore_weights
from detectinblur_tpu_torch.train.engine import make_eval_step
from detectinblur_tpu_torch.train.eval_loop import (
    dataset_to_coco_index,
    evaluate_coco,
)
from detectinblur_tpu_torch.utils.convert import (
    deepdeblur_from_torch,
    load_torch_state_dict,
    params_from_torchvision,
    torso_from_torchvision,
)
from detectinblur_tpu_torch.utils.device import resolve_device
from detectinblur_tpu_torch.utils.logging import ScalarWriter


# The natural-blur sets' one source bucket (GOPRO's 720x1280 frames).
NATURAL_SOURCE_BUCKETS = ((736, 1312),)


def load_params(model, path: str):
    """Weights into ``model``: a ``.pth`` holds torchvision (or reference
    checkpoint) weights, anything else is the port's own checkpoint or a
    bare state dict of the port. A model with BatchNorm statistics takes a
    ``.pth``'s BatchNorms unfolded, ``num_batches_tracked`` set to 16 as
    the reference's evaluate.py:234-237 sets it; the port's own checkpoint
    keeps the statistics and count it was saved with, or, if it holds none
    (a FrozenBatchNorm model wrote it), the model's fresh ones. A
    single-map detector's ``.pth`` is an ImageNet classifier: only its
    torso loads, the heads stay the model's random ones (JAX
    ``load_params``)."""
    if path.endswith(".pth"):
        sd = load_torch_state_dict(path)
        if isinstance(model, SingleMapFasterRCNN):
            model.load_state_dict({**model.state_dict(),
                                   **torso_from_torchvision(
                                       sd, model.cfg.backbone,
                                       frozen_bn=model.cfg.bn_mode is None,
                                       num_batches=16.0)})
            print("loaded ImageNet torso weights; detection heads are random")
            return model
        check_class_count(sd, model.cfg.num_classes, path)
        model.load_state_dict(params_from_torchvision(
            sd, model.cfg.num_classes, frozen_bn=not model.has_bn,
            num_batches=16.0))
        return model
    return restore_weights(path, model, fresh_bn_stats=model.has_bn)


def load_estimator(path: str, n_classes: int, device) -> ResNetClassifier:
    """The resnet18 blur estimator with eval-mode BatchNorm, its weights
    and running statistics from a ``cli.train_blur_estimator`` checkpoint
    or a bare state dict of the port (strict: the statistics must be in
    it, since eval-mode BatchNorm normalizes with them)."""
    estimator = ResNetClassifier("resnet18", n_classes, bn_mode="eval",
                                 device=device)
    return restore_weights(path, estimator).eval()


def load_deblurrer(path: str, device) -> MSResNet:
    """DeepDeblur's MSResNet from its PyTorch checkpoint, on ``device``."""
    net = MSResNet.from_state_dict(deepdeblur_from_torch(
        load_torch_state_dict(path)))
    return net.to(device=device, memory_format=torch.channels_last).eval()


def check_remedy_flags(args) -> None:
    """``ValueError`` for the flag combinations the JAX CLI evaluates
    wrongly or fails on (module docstring)."""
    if args.deblur_first != bool(args.deblurer_model_location):
        raise ValueError("--deblur_first and --deblurer_model_location go "
                         "together")
    if args.expand_synth_boxes and args.blurred_dataset != "GOPROSynth":
        raise ValueError("--expand_synth_boxes needs --blurred_dataset "
                         "GOPROSynth (the only set with optical flow)")
    if not args.use_ensemble:
        given = [f"--{d}" for d in ("ensemble_model_paths",
                                    "blur_estimator_path", "LEHE")
                 if getattr(args, d)]
        if given:
            raise ValueError(f"{', '.join(given)} need --use_ensemble")
        return
    for flag in ("mode_one_norm", "unfrozen_batch_norm"):
        if getattr(args, flag):
            raise ValueError(f"--use_ensemble with --{flag}: the ensemble "
                             "stacks FrozenBatchNorm specialists only")
    if len(args.ensemble_model_paths or ()) != 4:
        raise ValueError("--use_ensemble needs four --ensemble_model_paths, "
                         f"got {args.ensemble_model_paths}")
    if args.resume or args.start_from_weights:
        raise ValueError("--use_ensemble takes its weights from "
                         "--ensemble_model_paths, not --resume or "
                         "--start_from_weights")


def run_cell(args, model, dataset_val, policy: BlurPolicy, psf_bank,
             step_cache: Optional[dict] = None, ensemble=None,
             deblurrer: Optional[MSResNet] = None,
             source_buckets=None, coco_index=None) -> np.ndarray:
    """One COCO eval (engine.py:220-416 of the reference) of
    ``dataset_val`` under ``policy``: batch 1 in ``source_buckets`` (the
    loader's default when None), each image at its own model bucket, the
    eval steps cached by bucket in ``step_cache`` (shared across the
    sweep's cells), scored against ``coco_index`` (the dataset's own when
    None). With ``ensemble`` = (``Specialists``, estimator or None) each
    image goes to the specialist chosen for it (``model`` is their
    template). Prints the distinct model buckets this eval met and, for
    the ensemble, how many images each specialist got."""
    loader = DetectionLoader(
        dataset_val, 1, policy, psf_bank, shuffle=False,
        source_buckets=source_buckets, num_processes=process_count(),
        process_index=process_index(), drop_last=False,
        num_workers=args.workers)
    blur = policy.prob > 0
    expand = args.expand_target_boxes and blur
    eval_steps = step_cache if step_cache is not None else {}
    met = set()
    remedies = dict(
        blur_eval=blur, expand_target_boxes=expand,
        use_warp=args.warp_in_model,
        use_custom_norm=args.use_custom_image_norm, deblurrer=deblurrer,
        add_noise=args.add_noise, noise_level=args.noise_level,
        add_block=args.add_block, add_jpeg=args.add_jpeg_artefacts,
        dilate_psf=args.dilate_psf)
    choices = []

    def eval_step(m, batch, generator):
        b = model_bucket_for_batch(batch.hw)
        met.add(b)
        if ensemble is None:
            if b not in eval_steps:
                eval_steps[b] = make_eval_step(model, b, **remedies)
            return eval_steps[b](m, batch, generator)
        specialists, estimator = ensemble
        if b not in eval_steps:
            eval_steps[b] = make_ensemble_predict(
                model, b, estimator, lehe=args.LEHE, **remedies)
        dets, gt, index = eval_steps[b](specialists, batch, generator)
        choices.append(index)
        return dets, gt

    stats, _ = evaluate_coco(
        eval_step, model, loader,
        dataset_val.index if coco_index is None else coco_index,
        expand_target_boxes=expand, early_stop=args.early_stop,
        image_output_dir=args.image_output_dir)
    print(f"model buckets met: {len(met)} {sorted(met)}")
    if choices:
        counts = torch.bincount(torch.stack(choices).cpu(), minlength=4)
        print(f"ensemble specialists chosen (images each): {counts.tolist()}")
    return stats


def main(argv=None):
    """Returns the 19 stats of a clean or a natural-blur eval, or
    {(param_index, fraction_index): stats} for the blur sweep."""
    parser = eval_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args)
    check_remedy_flags(args)
    with process_group(args, args.device):
        return evaluate(args)


def evaluate(args):
    device = resolve_device(args.device)
    np.random.seed(1337)

    ensemble = None
    if args.use_ensemble:
        models = [load_params(build_model(args, device), p)
                  for p in args.ensemble_model_paths]
        specialists = stack_specialists(models)
        model = models[0]
        del models
        estimator = (load_estimator(args.blur_estimator_path,
                                    4 if args.LEHE else 16, device)
                     if args.blur_estimator_path else None)
        ensemble = (specialists, estimator)
    else:
        model = build_model(args, device)
        path = args.resume or args.start_from_weights
        if path:
            load_params(model, path)
        else:
            print("no checkpoint given; evaluating random weights")
    deblurrer = (load_deblurrer(args.deblurer_model_location, device)
                 if args.deblur_first else None)
    cell = functools.partial(run_cell, ensemble=ensemble, deblurrer=deblurrer)

    writer = ScalarWriter(args.tensorboard_path)
    try:
        if args.blurred_dataset:
            # Pre-blurred images: no synthetic blur, every other remedy
            # (evaluate.py:240-290 of the reference).
            kw = ({"expand_boxes": args.expand_synth_boxes}
                  if args.blurred_dataset == "GOPROSynth" else {})
            ds = get_natural_dataset(args.blurred_dataset, args.data_path,
                                     **kw)
            stats = cell(args, model, ds, BlurPolicy(prob=0.0), None,
                         source_buckets=NATURAL_SOURCE_BUCKETS,
                         coco_index=dataset_to_coco_index(ds))
            for name, value in zip(BLUR_STAT_TAGS, stats[:12]):
                writer.add_scalar(f"{args.blurred_dataset}/{name}",
                                  float(value), 0)
            return stats

        dataset_val, = get_datasets(args, ("val",))
        if args.vanilla_eval or not args.blur_eval:
            stats = cell(args, model, dataset_val, BlurPolicy(prob=0.0), None)
            for name, value in zip(BLUR_STAT_TAGS, stats[:12]):
                writer.add_scalar(f"Normal/{name}", float(value), 0)
            return stats

        # The sweep skips param 0 and fraction 0 (evaluate.py:302-310).
        if args.use_stored_psfs:
            if not args.stored_psf_directory:
                raise ValueError("--use_stored_psfs requires "
                                 "--stored_psf_directory")
            bank = load_psf_bank(args.stored_psf_directory, max_bank=256)
        else:
            # At the sweep's own exposures (evaluate.py:299-322); its
            # fraction indices line up with BLUR_FRACTIONS', which the
            # decisions quantize to.
            t0 = time.perf_counter()
            bank = generate_psf_bank(
                torch.Generator(device=device).manual_seed(7), bank_size=256,
                fractions=tuple(EVAL_FRACTIONS[1:]),
                center=not args.dont_center_psf)
            print(f"PSF bank {bank.shape} generated on {device} in "
                  f"{time.perf_counter() - t0:.3f} s")
        all_stats = {}
        step_cache = {}
        for pi, param in enumerate(EVAL_PARAMS[1:], start=1):
            if args.param_index is not None and pi != args.param_index:
                continue
            for fi, fraction in enumerate(EVAL_FRACTIONS[1:], start=1):
                policy = BlurPolicy(prob=1.0, blur_type=param,
                                    blur_exposure=fraction)
                stats = cell(args, model, dataset_val, policy, bank,
                             step_cache=step_cache)
                all_stats[(pi, fi)] = stats
                for name, value in zip(BLUR_STAT_TAGS, stats[:12]):
                    writer.add_scalar(f"P{pi}/{name}", float(value), fi)
                print(f"P{pi} E{fi} (param={param}, fraction={fraction:.3f}): "
                      f"mAP={stats[0]:.4f}")
        return all_stats
    finally:
        writer.close()


if __name__ == "__main__":
    main()
