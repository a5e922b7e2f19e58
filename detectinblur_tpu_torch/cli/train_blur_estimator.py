"""Blur-estimator training entry point.

    python -m detectinblur_tpu_torch.cli.train_blur_estimator \\
        --data-path /data/coco --LEHE_blur_seg --resize_images \\
        --crop_images [--test_only --resume model_9.pt] [--device cpu]

Port of ``detectinblur_tpu/cli/train_blur_estimator.py``
(train_blur_estimator.py of the reference): resnet18 to 16 classes (no
blur + 3 blur types x 5 exposures), or 4 with ``--LEHE`` /
``--LEHE_blur_seg``, trained on COCO blurred on the card with the blur
policy ``BlurPolicy(prob=0.9)`` (LEHE's class-weighted sampling with
``--LEHE_blur_seg``) and a bank of 512 PSFs per (type, exposure);
cross-entropy with optional label smoothing, SGD with weight decay, the
learning rate divided by 10 at epochs 6 and 8. The corruptions
(``--add_noise``, ``--add_block``, ``--add_jpeg_artefacts``,
``--quantize_image``), ``--resize_images`` (blur at min side 800) and
``--crop_images`` follow their flags. After training (or alone, with
``--test_only``) one eval prints top-1, top-2 and the mean per-class
accuracy; ``--test_only`` also prints the confusion matrix (rows: truth)
and saves it as ``confusion_matrix.npy``. Training writes one
checkpoint, ``model_{epochs - 1}.pt``, running statistics included.

``--pretrained`` (``{output_dir}/resnet18_imagenet.pth``) or a ``.pth``
``--start_from_weights`` loads a torchvision resnet18 trunk and keeps the
fresh ``fc``; a missing file raises (JAX trains from scratch). Another
``--start_from_weights`` is a checkpoint of this CLI. ``--dataset
GOPROBlurEst`` trains and evaluates on a rendered GOPRO set's split lists
(``cli/dataset_tools.py segment-gopro``): pre-blurred images with their
stored LEHE class, so it requires ``--LEHE_blur_seg`` as in JAX (the
16-class labels would all be 0). The common flags this CLI does not read
raise ``NotImplementedError``.

Under ``torchrun --nproc_per_node N`` it trains data-parallel as
``cli.train`` does (per-process seeds, shards, one model bucket a step,
the gradients of the global batch, the checkpoint from process 0); the
eval's rows are gathered from every process before the accuracies.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from detectinblur_tpu_torch.cli.args import (
    EVAL_ONLY,
    estimator_parser,
    refuse_unported,
)
from detectinblur_tpu_torch.data.batching import model_bucket_for
from detectinblur_tpu_torch.data.blur_sampling import BlurPolicy, generate_psf_bank
from detectinblur_tpu_torch.data.coco import get_coco
from detectinblur_tpu_torch.data.loader import DetectionLoader, steps_together
from detectinblur_tpu_torch.data.natural_datasets import GOPROBlurEst
from detectinblur_tpu_torch.models.classifier import ResNetClassifier
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
from detectinblur_tpu_torch.train.estimator_engine import (
    make_estimator_eval_step,
    make_estimator_train_step,
)
from detectinblur_tpu_torch.train.state import TrainState, make_lr_schedule
from detectinblur_tpu_torch.utils.convert import (
    classifier_from_torchvision,
    load_torch_state_dict,
)
from detectinblur_tpu_torch.utils.device import resolve_device
from detectinblur_tpu_torch.utils.logging import ScalarWriter
from detectinblur_tpu_torch.utils.metric_logger import MetricLogger

# The common flags (cli/args.py) that the estimator's training never reads.
NOT_READ = tuple(d for d in EVAL_ONLY if d != "LEHE") + (
    "trainable_backbone_blocks", "start_epoch", "blur_train", "blur_eval",
    "use_stored_psfs", "stored_psf_directory", "param_index",
    "high_exposure", "low_exposure", "expand_target_boxes",
    "dont_center_psf", "warp_in_model", "use_custom_image_norm",
    "unfrozen_batch_norm", "non_pos_aug_mix", "include_pos_aug_mix",
    "aug_mix_target_expand")


class EstimatorRun(NamedTuple):
    state: TrainState
    losses: List[Dict[str, float]]   # the metrics of each printed step
    top1: float
    top2: float
    mean_class_acc: float
    confusion: np.ndarray            # [n, n], rows the true class


def confusion_matrix(preds, labels, n: int) -> np.ndarray:
    cm = np.zeros((n, n), np.int64)
    np.add.at(cm, (np.asarray(labels), np.asarray(preds)), 1)
    return cm


def merge_rows(ids, *columns):
    """Each column's rows of every process, an image's row from the first
    process that evaluated it (the padded shards evaluate up to P-1
    images twice), as the detector's eval merge keeps them. The columns
    as they are in one process."""
    if process_count() == 1:
        return columns
    gathered = [None] * process_count()
    dist.all_gather_object(gathered, (ids, *columns))
    seen, out = set(), [[] for _ in columns]
    for host_ids, *host_columns in gathered:
        for k, i in enumerate(host_ids):
            if i not in seen:
                seen.add(i)
                for col, host_col in zip(out, host_columns):
                    col.append(host_col[k])
    return out


def load_initial_weights(args, classifier: ResNetClassifier) -> None:
    """``--pretrained`` or a ``.pth`` ``--start_from_weights``: a
    torchvision resnet18 trunk, the fresh ``fc`` kept; a missing file
    raises. Another ``--start_from_weights``: this CLI's checkpoint."""
    if args.pretrained or args.start_from_weights.endswith(".pth"):
        path = args.start_from_weights or os.path.join(
            args.output_dir, "resnet18_imagenet.pth")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no resnet18 weights at {path}")
        trunk = classifier_from_torchvision(
            load_torch_state_dict(path), num_classes=classifier.num_classes)
        classifier.load_state_dict({**classifier.state_dict(), **trunk})
        print(f"loaded the resnet18 trunk from {path}")
    elif args.start_from_weights:
        restore_weights(args.start_from_weights, classifier)


def main(argv=None) -> EstimatorRun:
    parser = estimator_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args, not_read=NOT_READ,
                    datasets=("coco", "GOPROBlurEst"))
    if args.dataset == "GOPROBlurEst" and not args.LEHE_blur_seg:
        raise ValueError("--dataset GOPROBlurEst requires --LEHE_blur_seg: "
                         "its stored labels are LEHE classes")
    with process_group(args, args.device):
        return train_estimator(args)


def train_estimator(args) -> EstimatorRun:
    device = resolve_device(args.device)
    np.random.seed(1337 + process_index() * 1337)

    lehe = args.LEHE or args.LEHE_blur_seg
    n_classes = 4 if lehe else 16
    classifier = ResNetClassifier("resnet18", n_classes, device=device)
    policy = BlurPolicy(prob=0.9, lehe_blur_seg=args.LEHE_blur_seg)
    t0 = time.perf_counter()
    bank = generate_psf_bank(torch.Generator(device=device).manual_seed(7),
                             bank_size=512)
    print(f"PSF bank {bank.shape} generated on {device} in "
          f"{time.perf_counter() - t0:.3f} s")
    if args.dataset == "GOPROBlurEst":
        dataset = GOPROBlurEst(args.data_path, "train")
        dataset_val = GOPROBlurEst(args.data_path, "val")
    else:
        dataset = get_coco(args.data_path, "train")
        dataset_val = get_coco(args.data_path, "val")
    loader = DetectionLoader(
        dataset, args.batch_size, policy, bank, shuffle=True, hflip_prob=0.5,
        num_processes=process_count(), process_index=process_index(),
        num_workers=args.workers)

    load_initial_weights(args, classifier)
    schedule = make_lr_schedule(args.lr, max(len(loader), 1),
                                milestones=(6, 8))
    optimizer = torch.optim.SGD(classifier.parameters(), lr=schedule(0),
                                momentum=args.momentum,
                                weight_decay=args.weight_decay)
    state = TrainState(0, classifier, optimizer)
    if args.resume:
        state = restore_checkpoint(args.resume, state)
        print(f"resumed from {args.resume}")

    writer = ScalarWriter(args.tensorboard_path)
    generator = torch.Generator(device=device).manual_seed(
        3 + process_index() * 1337)
    losses: List[Dict[str, float]] = []
    try:
        steps = {}
        for epoch in range(0 if args.test_only else args.epochs):
            loader.set_epoch(epoch)
            logger = MetricLogger()
            for it, (batch, bucket, _) in enumerate(logger.log_every(
                    steps_together(loader), args.print_freq,
                    f"Epoch [{epoch}]")):
                # One model bucket on every process: the largest of theirs.
                bucket = agree_max(model_bucket_for(bucket))
                if bucket not in steps:
                    steps[bucket] = make_estimator_train_step(
                        classifier, schedule, bucket,
                        lehe=lehe, label_smoothing=args.label_smoothing,
                        add_noise=args.add_noise, noise_level=args.noise_level,
                        add_block=args.add_block,
                        add_jpeg=args.add_jpeg_artefacts,
                        quantize=args.quantize_image,
                        resize_images=args.resize_images,
                        crop_images=args.crop_images)
                state, metrics = steps[bucket](state, batch,
                                               generator=generator)
                if it % args.print_freq == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    if not np.isfinite(m["loss"]):
                        raise RuntimeError(f"Loss is {m['loss']}, aborting")
                    losses.append(m)
                    logger.update(**m)
                    writer.add_scalar("losses/ce", m["loss"], state.step)
                # As JAX's: the batch at index early_stop is the last.
                if args.early_stop and it >= args.early_stop:
                    break

        val_loader = DetectionLoader(
            dataset_val, args.batch_size, policy, bank, shuffle=False,
            drop_last=False, num_processes=process_count(),
            process_index=process_index(), num_workers=args.workers)
        eval_steps = {}
        ids, preds, labels, top2 = [], [], [], []
        for it, (batch, bucket, image_ids) in enumerate(val_loader):
            if bucket not in eval_steps:
                eval_steps[bucket] = make_estimator_eval_step(
                    classifier, model_bucket_for(bucket), lehe=lehe,
                    resize_images=args.resize_images,
                    crop_images=args.crop_images)
            out = eval_steps[bucket](batch)
            ids += [int(i) for i in image_ids]
            preds += out["pred"].tolist()
            labels += out["label"].tolist()
            top2 += out["top2_hit"].tolist()
            if args.early_stop and it >= args.early_stop:
                break
        preds, labels, top2 = merge_rows(ids, preds, labels, top2)
        preds, labels = np.asarray(preds), np.asarray(labels)
        top1 = float((preds == labels).mean())
        top2_acc = float(np.mean(top2))
        per_class = [float((preds[labels == c] == c).mean())
                     for c in range(n_classes) if (labels == c).any()]
        mean_class = float(np.mean(per_class)) if per_class else 0.0
        print(f"Top1 {top1:.4f}  Top2 {top2_acc:.4f}  "
              f"MeanClassAcc {mean_class:.4f}")
        writer.add_scalar("Blurred/Top1Accuracy", top1, 0)
        writer.add_scalar("Blurred/Top2Accuracy", top2_acc, 0)
        cm = confusion_matrix(preds, labels, n_classes)
        if args.test_only:
            print("confusion matrix (rows=gt):")
            print(cm)
            if args.output_dir:
                os.makedirs(args.output_dir, exist_ok=True)
                np.save(os.path.join(args.output_dir, "confusion_matrix.npy"),
                        cm)
        elif args.output_dir:
            save_checkpoint(args.output_dir, state, args.epochs - 1,
                            vars(args))
    finally:
        writer.close()
    return EstimatorRun(state, losses, top1, top2_acc, mean_class, cm)


if __name__ == "__main__":
    main()
