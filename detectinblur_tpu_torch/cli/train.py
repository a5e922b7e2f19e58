"""Training entry point.

    python -m detectinblur_tpu_torch.cli.train --data-path /data/coco \\
        --blur_train --expand_target_boxes [--device cpu]

Port of ``detectinblur_tpu/cli/train.py`` (train.py:89-391 of the
reference), in one process, for ``--model`` ``fasterrcnn_resnet50_fpn``
(the default), ``mobile_net`` or ``resnet_50`` (the single-map detectors
of ``models/backbones.py``), on ``--dataset coco`` (91 classes) or
``coco_kp`` (COCO's person-keypoint annotations, 2 classes): COCO train
split -> loader (AugMix, hflip
0.5, blur decisions) -> PSF bank (generated on the card, or stored) ->
per-batch train steps (blur, corruptions, GT expansion, loss, backward,
SGD), the non-finite loss guard, a checkpoint each epoch and a clean plus
a blurred COCO eval after it (``--eval_first`` also before training).
The in-detector remedies follow their flags: ``--warp_in_model``,
``--use_custom_image_norm``, ``--unfrozen_batch_norm`` (the backbone's
BatchNorms in ``train`` mode, also in the evals), ``--add_noise``,
``--add_block``, ``--add_jpeg_artefacts`` and the AugMix flags. Flags the
port does not have yet raise ``NotImplementedError`` (``cli/args.py``),
and so do the flags of deblur-first, of the ensemble, of the natural-blur
datasets and ``--image_output_dir``, which only ``cli.evaluate`` reads.

Data parallel, one process per card (the reference's DDP)::

    torchrun --nproc_per_node N -m detectinblur_tpu_torch.cli.train ...

``-b`` is the batch per card. Each process reads its shard of the data
and seeds numpy and its generator with ``1337 + rank * 1337`` (JAX
cli/train.py:108); before each step the processes agree that each has a
batch and on one model bucket, the largest of theirs (that of the global
batch), and the step reduces the gradients of the global batch
(``train/engine.py``). Checkpoints and scalars come from process 0; the
evals are merged across the processes. A detector
``.pth`` whose box predictor has another class count than the dataset's
raises ``ValueError`` naming both when the file is loaded, before the
first step; JAX fails on it at that step, in Flax's shape check
(ROADMAP, Queue 3).

As in JAX, each batch's model bucket comes from ``model_bucket_for_batch``
with the FPN's 800/1333 for every model, so a single-map detector resizes
to 300/500 inside a larger canvas (ROADMAP, Queue 3).
"""

from __future__ import annotations

import os
import time
from dataclasses import replace
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from detectinblur_tpu_torch.cli.args import (
    EVAL_ONLY,
    bn_mode_for,
    refuse_unported,
    train_parser,
)
from detectinblur_tpu_torch.data.batching import model_bucket_for_batch
from detectinblur_tpu_torch.data.blur_sampling import (
    BlurPolicy,
    generate_psf_bank,
    load_psf_bank,
)
from detectinblur_tpu_torch.data.coco import get_coco, get_coco_kp
from detectinblur_tpu_torch.data.loader import DetectionLoader, steps_together
from detectinblur_tpu_torch.models.backbones import (
    SingleMapConfig,
    SingleMapFasterRCNN,
)
from detectinblur_tpu_torch.models.faster_rcnn import (
    FasterRCNN,
    FasterRCNNConfig,
    TwoStageDetector,
)
from detectinblur_tpu_torch.ops.psf import BLUR_PARAMS, EVAL_PARAMS
from detectinblur_tpu_torch.parallel.dist import (
    agree_max,
    process_count,
    process_group,
    process_index,
)
from detectinblur_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    restore_weights,
    save_checkpoint,
)
from detectinblur_tpu_torch.train.engine import make_eval_step, make_train_step
from detectinblur_tpu_torch.train.eval_loop import evaluate_coco
from detectinblur_tpu_torch.train.state import TrainState, create_train_state, make_optimizer
from detectinblur_tpu_torch.utils.convert import (
    load_torch_state_dict,
    params_from_torchvision,
    torso_from_torchvision,
)
from detectinblur_tpu_torch.utils.device import resolve_device
from detectinblur_tpu_torch.utils.logging import ScalarWriter
from detectinblur_tpu_torch.utils.metric_logger import MetricLogger

BLUR_STAT_TAGS = ["AveragePrecision", "AP50", "AP75", "APSmall", "APMedium",
                  "APLarge", "AR1", "AR10", "AR100", "ARSmall", "ARMedium",
                  "ARLarge"]


class TrainRun(NamedTuple):
    state: TrainState
    losses: List[Dict[str, float]]      # the losses of each printed step
    evals: Dict[str, np.ndarray]        # "{Normal,Blurred}/{epoch}" -> 19 stats


# --model -> the single-map detector's torso (JAX cli/train.py:38-58).
SINGLE_MAP_TORSOS = {"mobile_net": "mobile_net", "resnet_50": "resnet50"}
# The box predictor's output row per class, background included.
PREDICTOR_KEY = "roi_heads.box_predictor.cls_score.weight"


def num_classes_for(args) -> int:
    """2 (background and person) for ``--dataset coco_kp``, else COCO's 91
    (JAX cli/train.py:43)."""
    return 2 if args.dataset == "coco_kp" else 91


def get_datasets(args, splits=("train", "val")):
    """The ``--dataset``'s COCO splits: instances, or person keypoints."""
    get = get_coco_kp if args.dataset == "coco_kp" else get_coco
    return [get(args.data_path, split) for split in splits]


def check_class_count(sd, num_classes: int, path: str) -> None:
    """``ValueError`` naming both counts if the detector state dict's box
    predictor has another class count than the model."""
    if PREDICTOR_KEY in sd and sd[PREDICTOR_KEY].shape[0] != num_classes:
        raise ValueError(
            f"{path} has a {sd[PREDICTOR_KEY].shape[0]}-class box "
            f"predictor; the model has {num_classes} classes")


def build_model(args, device) -> TwoStageDetector:
    """The ``--model`` detector with the ``--dataset``'s classes on
    ``device``: Faster R-CNN ResNet50-FPN, warping inside with
    ``--warp_in_model``, or the single-map ``mobile_net`` / ``resnet_50``
    (min 300 / max 500, no warp: JAX's build ignores the flag); the
    BatchNorms in the mode the flags ask for (``bn_mode_for``)."""
    if args.model in SINGLE_MAP_TORSOS:
        return SingleMapFasterRCNN(SingleMapConfig(
            SINGLE_MAP_TORSOS[args.model], num_classes=num_classes_for(args),
            bn_mode=bn_mode_for(args)), device=device)
    return FasterRCNN(FasterRCNNConfig(
        num_classes=num_classes_for(args), warp_internally=args.warp_in_model,
        bn_mode=bn_mode_for(args)), device=device)


def load_initial_params(args, model: TwoStageDetector) -> TwoStageDetector:
    """``--pretrained`` or a ``.pth`` ``--start_from_weights``: torchvision
    weights into ``model``; only ``--pretrained``'s default file may be
    missing, and then training starts from scratch.

    The FPN detector takes a whole detector
    (``{output_dir}/fasterrcnn_resnet50_fpn_coco.pth``); a ``bn_mode``
    model takes its BatchNorms unfolded (gamma, beta and the running
    statistics of the file), where the JAX package folds them and starts
    from fresh statistics (ROADMAP, Queue 3). A single-map detector takes
    an ImageNet classifier's torso (``{output_dir}/{backbone}_imagenet.pth``:
    MobileNetV2 with its running statistics, or the resnet trunk, folded
    unless ``bn_mode``) and keeps its random heads, as JAX does."""
    if not (args.pretrained or args.start_from_weights.endswith(".pth")):
        return model
    single = isinstance(model, SingleMapFasterRCNN)
    default = (f"{model.cfg.backbone}_imagenet.pth" if single
               else "fasterrcnn_resnet50_fpn_coco.pth")
    path = args.start_from_weights or os.path.join(args.output_dir, default)
    if not args.start_from_weights and not os.path.exists(path):
        print(f"pretrained weights not found at {path}; training from scratch")
        return model
    sd = load_torch_state_dict(path)
    if single:
        model.load_state_dict({**model.state_dict(), **torso_from_torchvision(
            sd, model.cfg.backbone, frozen_bn=model.cfg.bn_mode is None)})
        print(f"loaded ImageNet torso weights from {path}; the detection "
              "heads stay random")
        return model
    check_class_count(sd, model.cfg.num_classes, path)
    model.load_state_dict(params_from_torchvision(
        sd, model.cfg.num_classes, frozen_bn=model.cfg.bn_mode is None))
    print(f"loaded torch weights from {path}")
    return model


def main(argv=None) -> TrainRun:
    """Train as the reference's train.py does."""
    parser = train_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args, not_read=EVAL_ONLY)
    with process_group(args, args.device):
        return train(args)


def train(args) -> TrainRun:
    device = resolve_device(args.device)
    np.random.seed(1337 + process_index() * 1337)

    dataset, dataset_val = get_datasets(args)

    policy = BlurPolicy.training_default(
        low=args.low_exposure, high=args.high_exposure
    ) if args.blur_train else BlurPolicy(prob=0.0)
    if args.param_index is not None:
        # A stored-PSF folder index 1-3, else an index into EVAL_PARAMS
        # (train.py:127-137).
        params_list = BLUR_PARAMS if args.use_stored_psfs else EVAL_PARAMS
        offset = -1 if args.use_stored_psfs else 0
        policy.blur_type = params_list[args.param_index + offset]

    psf_bank = None
    if args.blur_train:
        if args.use_stored_psfs:
            if not args.stored_psf_directory:
                raise ValueError("--use_stored_psfs requires "
                                 "--stored_psf_directory")
            psf_bank = load_psf_bank(args.stored_psf_directory)
        else:
            t0 = time.perf_counter()
            psf_bank = generate_psf_bank(
                torch.Generator(device=device).manual_seed(7), bank_size=512,
                center=not args.dont_center_psf)
            print(f"PSF bank {psf_bank.shape} generated on {device} in "
                  f"{time.perf_counter() - t0:.3f} s")

    augmix = None
    if args.non_pos_aug_mix or args.include_pos_aug_mix:
        augmix = dict(positional=args.include_pos_aug_mix,
                      modify_target_boxes=args.aug_mix_target_expand)
    loader = DetectionLoader(
        dataset, args.batch_size, policy, psf_bank, shuffle=True,
        hflip_prob=0.5, num_processes=process_count(),
        process_index=process_index(), augmix=augmix,
        num_workers=args.workers)

    model = load_initial_params(args, build_model(args, device))
    optimizer, schedule = make_optimizer(
        model, base_lr=args.lr, steps_per_epoch=max(len(loader), 1),
        momentum=args.momentum, weight_decay=args.weight_decay,
        milestones=args.lr_steps, gamma=args.lr_gamma,
        trainable_backbone_layers=args.trainable_backbone_blocks)
    state = create_train_state(model, optimizer)
    if args.resume:
        state = restore_checkpoint(args.resume, state)
        print(f"resumed from {args.resume}")
    elif args.start_from_weights and not args.start_from_weights.endswith(".pth"):
        restore_weights(args.start_from_weights, model)

    steps = {}        # model bucket -> train step
    eval_steps = {}   # (blur, model bucket) -> eval step, across epochs

    def step_for(hw):
        b = agree_max(model_bucket_for_batch(hw))
        if b not in steps:
            steps[b] = make_train_step(
                model, schedule, b, blur_train=args.blur_train,
                expand_target_boxes=args.expand_target_boxes,
                use_warp=args.warp_in_model,
                use_custom_norm=args.use_custom_image_norm,
                add_noise=args.add_noise, noise_level=args.noise_level,
                add_block=args.add_block, add_jpeg=args.add_jpeg_artefacts)
        return steps[b]

    writer = ScalarWriter(args.tensorboard_path)
    evals: Dict[str, np.ndarray] = {}

    def run_eval(epoch):
        """Clean and blurred eval (train.py:346-387); the blurred val set
        blurs every image."""
        for tag, blur in (("Normal", False), ("Blurred", True)):
            if blur and not args.blur_train:
                continue
            val_loader = DetectionLoader(
                dataset_val, 1,
                replace(policy, prob=1.0) if blur else BlurPolicy(prob=0.0),
                psf_bank if blur else None, shuffle=False,
                num_processes=process_count(), process_index=process_index(),
                drop_last=False, num_workers=args.workers)

            def eval_step(m, batch, generator, _blur=blur):
                b = (_blur, model_bucket_for_batch(batch.hw))
                if b not in eval_steps:
                    eval_steps[b] = make_eval_step(
                        model, b[1], blur_eval=_blur,
                        expand_target_boxes=args.expand_target_boxes and _blur,
                        use_warp=args.warp_in_model,
                        use_custom_norm=args.use_custom_image_norm)
                return eval_steps[b](m, batch, generator)

            stats, _ = evaluate_coco(
                eval_step, model, val_loader, dataset_val.index,
                expand_target_boxes=args.expand_target_boxes and blur,
                early_stop=args.early_stop)
            evals[f"{tag}/{epoch}"] = stats
            for name, value in zip(BLUR_STAT_TAGS, stats[:12]):
                writer.add_scalar(f"{tag}/{name}", float(value), epoch)

    generator = torch.Generator(device=device).manual_seed(
        1337 + process_index() * 1337)
    losses: List[Dict[str, float]] = []
    global_iter = 0
    try:
        if args.eval_first:
            run_eval(args.start_epoch - 1)
        for epoch in range(args.start_epoch, args.epochs):
            loader.set_epoch(epoch)
            if (args.blur_train and args.use_stored_psfs and epoch > 0
                    and psf_bank.shape[2] == 2048):
                # A full take means the stored bank was stride-subsampled:
                # re-stride so successive epochs walk disjoint slices.
                psf_bank = load_psf_bank(args.stored_psf_directory,
                                         epoch=epoch)
                loader.psf_bank = psf_bank
            logger = MetricLogger()
            t_epoch = time.time()
            for batch, _bucket, _ids in logger.log_every(
                steps_together(loader), args.print_freq, f"Epoch: [{epoch}]"
            ):
                state, metrics = step_for(batch.hw)(state, batch,
                                                    generator=generator)
                if global_iter % args.print_freq == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    if not np.isfinite(m["loss"]):
                        raise RuntimeError(f"Loss is {m['loss']}, aborting "
                                           f"(non-finite loss guard): {m}")
                    losses.append(m)
                    logger.update(**m)
                    writer.add_scalar("losses/totalLoss", m["loss"], global_iter)
                    for k, v in m.items():
                        if k != "loss":
                            writer.add_scalar(f"losses/{k}", v, global_iter)
                    writer.add_scalar("learningRate", schedule(global_iter),
                                      global_iter)
                global_iter += 1
                if args.early_stop is not None and global_iter >= args.early_stop:
                    break

            print(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s")
            if args.output_dir:
                save_checkpoint(args.output_dir, state, epoch, vars(args))
            run_eval(epoch)
            if args.early_stop is not None:
                break
    finally:
        writer.close()
    return TrainRun(state, losses, evals)


if __name__ == "__main__":
    main()
