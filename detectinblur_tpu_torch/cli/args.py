"""The CLI flag surface, with the JAX package's names and defaults
(``detectinblur_tpu/cli/args.py``, after the reference's train.py:393-488
and evaluate.py:378-468), except ``--device``, which defaults to ``cuda``.

Every flag is parsed as there. ``refuse_unported`` raises
``NotImplementedError`` naming a value the port does not support
(a ``--dataset`` or ``--model`` outside ``_SUPPORTED``), and each evaluation-only flag (``EVAL_ONLY``:
deblur-first, the ensemble, the natural-blur datasets and
``--image_output_dir``) given to ``cli.train``, which never reads them:
no flag is silently ignored. ``estimator_parser`` is
the blur estimator trainer's (JAX ``cli/train_blur_estimator.py:35-51``).
"""

from __future__ import annotations

import argparse
from typing import Optional

# dest -> what the port supports; any other value raises.
_SUPPORTED = {
    "dataset": ("coco", "coco_kp"),
    "model": ("fasterrcnn_resnet50_fpn", "mobile_net", "resnet_50"),
}
# Flags that only cli.evaluate reads (JAX's cli/train.py never does).
EVAL_ONLY = (
    "deblur_first", "deblurer_model_location",
    "use_ensemble", "ensemble_model_paths", "blur_estimator_path", "LEHE",
    "blurred_dataset", "expand_synth_boxes", "image_output_dir",
)


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset", default="coco")
    p.add_argument("--data-path", "--data_path", dest="data_path",
                   default="/data/coco")
    p.add_argument("-j", "--workers", default=4, type=int,
                   help="loader decode threads")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, or cpu when asked)")
    p.add_argument("-b", "--batch-size", dest="batch_size", default=8, type=int)

    p.add_argument("--model", default="fasterrcnn_resnet50_fpn",
                   choices=["fasterrcnn_resnet50_fpn", "mobile_net", "resnet_50"])
    p.add_argument("--trainable_backbone_blocks", default=3, type=int)
    p.add_argument("--pretrained", action="store_true")

    p.add_argument("--resume", default="")
    p.add_argument("--start_from_weights", default="")
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--early_stop", default=None, type=int,
                   help="truncate loops after N iterations (smoke runs)")

    p.add_argument("--tensorboard_path", default=None)
    p.add_argument("--output_dir", default=".")
    p.add_argument("--image_output_dir", default=None)
    p.add_argument("--print-freq", "--print_freq", dest="print_freq",
                   default=20, type=int)

    # blur flags
    p.add_argument("--blur_train", action="store_true")
    p.add_argument("--blur_eval", action="store_true")
    p.add_argument("--cpu_blur", action="store_true",
                   help="accepted for CLI parity; blur always runs on device")
    p.add_argument("--gpu_blur", action="store_true",
                   help="accepted for CLI parity; blur always runs on device")
    p.add_argument("--use_stored_psfs", action="store_true")
    p.add_argument("--stored_psf_directory", default=None)
    p.add_argument("--param_index", default=None, type=int)
    p.add_argument("--high_exposure", action="store_true")
    p.add_argument("--low_exposure", action="store_true")
    p.add_argument("--expand_target_boxes", action="store_true")
    p.add_argument("--dont_center_psf", action="store_true")
    p.add_argument("--add_noise", action="store_true")
    p.add_argument("--noise_level", default=0.001, type=float)
    p.add_argument("--add_block", action="store_true")
    p.add_argument("--add_jpeg_artefacts", action="store_true")

    p.add_argument("--warp_in_model", action="store_true")
    p.add_argument("--use_custom_image_norm", action="store_true")
    p.add_argument("--unfrozen_batch_norm", action="store_true")

    p.add_argument("--deblur_first", action="store_true")
    p.add_argument("--deblurer_model_location", default=None)

    # AugMix
    p.add_argument("--non_pos_aug_mix", action="store_true")
    p.add_argument("--include_pos_aug_mix", action="store_true")
    p.add_argument("--aug_mix_target_expand", action="store_true")

    # ensemble
    p.add_argument("--use_ensemble", action="store_true")
    p.add_argument("--ensemble_model_paths", nargs="+", default=None)
    p.add_argument("--blur_estimator_path", default=None)
    p.add_argument("--LEHE", action="store_true")

    # natural-blur datasets
    p.add_argument("--blurred_dataset", default=None,
                   choices=[None, "GOPRO", "GOPROSynth", "GOPROSynthLoad",
                            "REDS", "RealBlur", "VidBlur"])
    p.add_argument("--expand_synth_boxes", action="store_true")

    # distributed: one process per card, started by torchrun (--world-size
    # 1, the default, takes the launcher's count); -b is the batch per card
    p.add_argument("--world-size", dest="world_size", default=1, type=int)
    p.add_argument("--dist-url", dest="dist_url", default="env://")
    return p


def train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="detectinblur training (PyTorch)")
    add_common_args(p)
    p.add_argument("--epochs", default=37, type=int)
    p.add_argument("--lr", default=0.04, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--wd", "--weight-decay", "--weight_decay",
                   dest="weight_decay", default=1e-4, type=float)
    p.add_argument("--lr-steps", dest="lr_steps", nargs="+",
                   default=[16, 22], type=int)
    p.add_argument("--lr-gamma", dest="lr_gamma", default=0.1, type=float)
    p.add_argument("--aspect-ratio-group-factor", default=3, type=int,
                   help="accepted for CLI parity; batching always groups "
                        "by the static orientation/size buckets")
    p.add_argument("--eval_first", action="store_true")
    return p


def eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="detectinblur evaluation (PyTorch)")
    add_common_args(p)
    p.add_argument("--dilate_psf", action="store_true")
    p.add_argument("--mode_one_norm", action="store_true")
    p.add_argument("--vanilla_eval", action="store_true")
    return p


def estimator_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="blur estimator training (PyTorch)")
    add_common_args(p)
    p.add_argument("--epochs", default=10, type=int)
    p.add_argument("--lr", default=0.01, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--wd", "--weight-decay", dest="weight_decay",
                   default=1e-4, type=float)
    p.add_argument("--LEHE_blur_seg", action="store_true")
    p.add_argument("--crop_images", action="store_true")
    p.add_argument("--resize_images", action="store_true")
    p.add_argument("--quantize_image", action="store_true")
    p.add_argument("--test_only", action="store_true")
    p.add_argument("--label_smoothing", default=0.0, type=float)
    return p


def bn_mode_for(args) -> Optional[str]:
    """The backbone's BatchNorm mode the flags ask for: ``mode_one`` for
    --mode_one_norm (evaluation), ``train`` for --unfrozen_batch_norm,
    else None (FrozenBatchNorm)."""
    if getattr(args, "mode_one_norm", False):
        return "mode_one"
    return "train" if getattr(args, "unfrozen_batch_norm", False) else None


def set_flags(parser: argparse.ArgumentParser, args: argparse.Namespace,
              dests) -> list:
    """``--dest`` of each of ``dests`` set to another value than its
    default."""
    return [f"--{d}" for d in dests
            if hasattr(args, d) and getattr(args, d) != parser.get_default(d)]


def refuse_unported(parser: argparse.ArgumentParser,
                    args: argparse.Namespace, not_read=(),
                    datasets=_SUPPORTED["dataset"]) -> None:
    """Raise ``NotImplementedError`` naming every flag set to a value the
    port does not support yet (``--dataset`` outside ``datasets``), and
    every flag of ``not_read`` (those the calling CLI does not read) that
    was set."""
    supported = dict(_SUPPORTED, dataset=tuple(datasets))
    asked = [f"--{d} {getattr(args, d)}" for d, ok in supported.items()
             if getattr(args, d) not in ok]
    unread = set_flags(parser, args, not_read)
    if asked or unread:
        raise NotImplementedError(
            "; ".join(([f"not ported yet: {', '.join(asked)}"] if asked
                       else []) + ([f"not read by this CLI: "
                                    f"{', '.join(unread)}"] if unread
                                   else [])))
