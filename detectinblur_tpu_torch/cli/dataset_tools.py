"""Dataset preparation tools (the reference's dataset_utils/).

    python -m detectinblur_tpu_torch.cli.dataset_tools render-gopro-synth \
        --root_dir GOPRO --output_dir GOPROSynth [--window 5] [--expand_boxes]
    python -m detectinblur_tpu_torch.cli.dataset_tools segment-gopro \
        --root_dir GOPROSynth
    python -m detectinblur_tpu_torch.cli.dataset_tools segment-reds \
        --root_dir REDS

Port of ``detectinblur_tpu/cli/dataset_tools.py`` (numpy and PIL):

  * render-gopro-synth: render the GOPROSynth frame-averaged blur set to
    disk (blur/ + sharp/ pngs + pickled targets, capped at 7000 images —
    dataset_utils/generate_GOPRO_blur_set.py:26-62).
  * segment-gopro: write 90/10 estimator train/val split lists of
    "imagePath,blurLabel" lines in GOPROBlurEst's format
    (segment_GOPRO.py:44-82), over every .png of any letter case that has
    a .dat beside it.
  * segment-reds: cull images with no above-threshold DORS boxes (keeping
    at most 20 empty ones), cap at 5000, write blurry.txt/sharp.txt
    (segment_REDS.py:47-102).

Two behaviours of the JAX tool are not copied: a blur image whose .dat
cannot be read raises ``ValueError`` naming it, where JAX labels it class
2 (the middle class) and goes on; and ``segment-gopro`` takes ``.PNG``
trees too, where JAX's lower-case glob writes empty split files for them.
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
from pathlib import Path

import numpy as np
from PIL import Image

from detectinblur_tpu_torch.data.natural_datasets import (
    GOPROSynth,
    load_dors_targets,
    with_suffix,
)


def render_gopro_synth(args):
    ds = GOPROSynth(args.root_dir, window=args.window,
                    expand_boxes=args.expand_boxes)
    os.makedirs(os.path.join(args.output_dir, "blur"), exist_ok=True)
    os.makedirs(os.path.join(args.output_dir, "sharp"), exist_ok=True)
    for i in range(min(len(ds), args.limit)):
        item = ds[i]
        arr = item["image"]
        if arr.dtype != np.uint8:
            arr = (arr * 255).astype(np.uint8)
        img = Image.fromarray(arr)
        img.save(os.path.join(args.output_dir, f"blur/{i:05d}.png"))
        with open(os.path.join(args.output_dir, f"blur/{i:05d}.dat"), "wb") as f:
            payload = {k: item[k] for k in ("boxes", "labels", "area", "iscrowd")}
            # GOPROBlurEst reads the averaging window back out of the .dat
            # (custom_datasets.py:1115-1119 windowSize).
            payload["windowSize"] = 2 * args.window + 1
            pickle.dump(payload, f)
        # The reference renderer also writes the sharp CENTER frame and its
        # un-expanded targets (generate_GOPRO_blur_set.py:39-56) so the
        # estimator split has a no-blur class.
        frames, center = ds.centers[i]
        with Image.open(frames[center]) as sharp:
            sharp.convert("RGB").save(
                os.path.join(args.output_dir, f"sharp/{i:05d}.png"))
        sb, sl, sa = load_dors_targets(
            with_suffix(frames[center], "_DORS.npy"), ds.threshold)
        with open(os.path.join(args.output_dir, f"sharp/{i:05d}.dat"), "wb") as f:
            pickle.dump({"boxes": sb, "labels": sl, "area": sa,
                         "iscrowd": np.zeros(len(sl), np.int32)}, f)
        if i % 100 == 0:
            print(f"rendered {i}/{min(len(ds), args.limit)}")


def _blur_label_for(path: str) -> int:
    """Estimator class for a rendered image: 0 for sharp frames, else a
    LEHE-style class from the averaging window stored in its .dat. The
    reference's split labels come from GTBlurEstFiles pickles whose
    generator is not in the reference repo (segment_GOPRO.py:30-37 only
    loads them), so the window -> class map is the JAX package's stand-in:
    a wider window is a stronger blur class. A readable .dat without a
    window gets class 2 and a warning; an unreadable one raises."""
    if "sharp" in os.path.basename(os.path.dirname(path)):
        return 0
    dat = with_suffix(path, ".dat")
    try:
        with open(dat, "rb") as f:
            target = pickle.load(f)
    except Exception as e:
        raise ValueError(f"{dat}: unreadable target file ({e!r}); "
                         "re-render the tree") from e
    w = int(target.get("windowSize", 0))
    if w <= 0:
        print(f"WARNING: {path}: blur .dat has no windowSize; "
              "labeling as class 2 (middle) - re-render with "
              "render-gopro-synth for real labels")
        return 2
    return 1 if w <= 7 else (2 if w <= 13 else 3)


def segment_gopro(args):
    """90/10 estimator split lists in GOPROBlurEst's format: one
    "imagePath,blurLabel" line per image (int label — the reference writes
    the label from its GTBlurEstFiles pickles, segment_GOPRO.py:64-82, and
    GOPROBlurEst int()s the field, custom_datasets.py:1090-1096)."""
    rng = np.random.default_rng(1337)
    pairs = []
    for p in sorted(Path(args.root_dir).rglob("*.[pP][nN][gG]")):
        if os.path.exists(with_suffix(p, ".dat")):
            pairs.append((str(p), _blur_label_for(str(p))))
    rng.shuffle(pairs)
    cut = math.ceil(0.9 * len(pairs))
    for name, chunk in (("trainSplit.txt", pairs[:cut]), ("valSplit.txt", pairs[cut:])):
        with open(os.path.join(args.root_dir, name), "w") as f:
            for img, label in chunk:
                f.write(f"{img},{label}\n")
    print(f"{len(pairs)} pairs -> {cut} train / {len(pairs) - cut} val")


def segment_reds(args):
    allowed_empty = 20
    empty = 0
    kept = []
    for p in sorted(Path(args.root_dir).rglob("*.png")):
        if "blur" not in str(p):
            continue
        ann = with_suffix(str(p).replace("blur", "sharp"), "_DORS.npy")
        if not os.path.exists(ann):
            continue
        with open(ann, "rb") as f:
            annotations = np.load(f, allow_pickle=True)
        n = sum(int((np.asarray(a).reshape(-1, 5)[:, 4] > args.threshold).sum())
                for a in annotations)
        if n == 0:
            empty += 1
            if empty > allowed_empty:
                continue
        kept.append(str(p))
    kept = kept[:5000]
    with open(os.path.join(args.root_dir, "blurry.txt"), "w") as f:
        f.write("\n".join(kept) + "\n")
    with open(os.path.join(args.root_dir, "sharp.txt"), "w") as f:
        f.write("\n".join(k.replace("blur", "sharp") for k in kept) + "\n")
    print(f"kept {len(kept)} images ({empty} empty seen)")


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render-gopro-synth")
    r.add_argument("--root_dir", required=True)
    r.add_argument("--output_dir", required=True)
    r.add_argument("--window", type=int, default=5)
    r.add_argument("--expand_boxes", action="store_true")
    r.add_argument("--limit", type=int, default=7000)

    g = sub.add_parser("segment-gopro")
    g.add_argument("--root_dir", required=True)

    s = sub.add_parser("segment-reds")
    s.add_argument("--root_dir", required=True)
    s.add_argument("--threshold", type=float, default=0.4)

    args = p.parse_args(argv)
    {"render-gopro-synth": render_gopro_synth,
     "segment-gopro": segment_gopro,
     "segment-reds": segment_reds}[args.cmd](args)


if __name__ == "__main__":
    main()
