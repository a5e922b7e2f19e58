"""The port's natural-blur datasets and dataset tools held against the JAX
package's on on-disk synthetic trees in the reference's layouts: every
dataset class gives JAX's items exactly (each key, value and dtype),
the optical-flow box expansion is JAX's to the bit, and the tools
(``render-gopro-synth``, ``segment-gopro``, ``segment-reds``) write what
JAX's write, apart from the two behaviours the port does not copy (an
unreadable ``.dat`` and upper-case ``.PNG`` trees), shown here."""

import os
import pickle
import shutil

import numpy as np
import pytest
from PIL import Image

import detectinblur_tpu.cli.dataset_tools as jax_tools
import detectinblur_tpu.data.natural_datasets as jax_nat
import detectinblur_tpu_torch.cli.dataset_tools as tools
import detectinblur_tpu_torch.data.natural_datasets as nat

H, W = 24, 40


def _dors(rng, n=3):
    """An 80-class DORS dump: ``n`` boxes spread over three classes with
    scores around the 0.4 and 0.6 thresholds."""
    dors = np.empty(80, object)
    for c in range(80):
        dors[c] = np.zeros((0, 5), np.float32)
    for c in (0, 11, 79):
        rows = np.zeros((n, 5), np.float32)
        rows[:, :2] = rng.uniform(0, 20, (n, 2))
        rows[:, 2:4] = rows[:, :2] + rng.uniform(2, 15, (n, 2))
        rows[:, 4] = rng.choice([0.3, 0.5, 0.7, 0.95], n)
        dors[c] = rows
    return dors


def _png(path, rng, ext=".png"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path + ext, format="PNG" if ext.lower() ==
                              ".png" else "JPEG")


def _npy(path, value):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        np.save(f, value, allow_pickle=True)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One directory per layout, from seed 0: GOPRO (train and test
    sequences, one of upper-case .PNG frames, each sharp frame with its
    DORS dump and forward/backward flows), VidBlur, RealBlur's list
    files, REDS's image lists."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("natural")
    gopro = root / "gopro"
    for split, seq, n, ext in (("train", "s0", 7, ".png"),
                               ("test", "s1", 6, ".PNG")):
        for i in range(n):
            for kind in ("blur", "sharp"):
                _png(str(gopro / split / seq / kind / f"{i:06d}"), rng, ext)
            base = str(gopro / split / seq / "sharp" / f"{i:06d}")
            _npy(base + "_DORS.npy", _dors(rng))
            for tag in ("_flow.npy", "_flow_bwd.npy"):
                _npy(base + tag, rng.normal(0, 2, (H, W, 2)).astype(
                    np.float32))
    vid = root / "vidblur"
    for i in range(3):
        _png(str(vid / "seq" / "input" / f"{i}"), rng, ".jpg")
        _npy(str(vid / "seq" / "GT" / f"{i}_DORS.npy"), _dors(rng))
    real = root / "realblur"
    lines = []
    for i in range(3):
        _png(str(real / "scene" / "gt" / f"g{i}"), rng)
        _png(str(real / "scene" / "blur" / f"b{i}"), rng)
        _npy(str(real / "scene" / "gt" / f"g{i}_DORS.npy"), _dors(rng))
        lines.append(f"scene/gt/g{i}.png scene/blur/b{i}.png")
    (real / "RealBlur_J_train_list.txt").write_text("\n".join(lines[:2]) + "\n")
    (real / "RealBlur_J_test_list.txt").write_text(lines[2] + "\n\n")
    reds = root / "reds"
    for i in range(3):
        _png(str(reds / "seq" / "blur" / f"{i:02d}"), rng)
        _png(str(reds / "seq" / "sharp" / f"{i:02d}"), rng)
        _npy(str(reds / "seq" / "sharp" / f"{i:02d}_DORS.npy"), _dors(rng))
    return {k: str(v) for k, v in (("gopro", gopro), ("vidblur", vid),
                                   ("realblur", real), ("reds", reds))}


def _same_items(ours, ref):
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys(), i
        for k in b:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, (i, k)
            assert np.array_equal(x, y), (i, k)


CASES = {
    "GOPRO": ("gopro", {}),
    "GOPRO-sharp": ("gopro", {"sharp_images": True}),
    "VidBlur": ("vidblur", {}),
    "RealBlur": ("realblur", {}),
    "RealBlur-sharp": ("realblur", {"sharp_images": True}),
    "GOPROSynth": ("gopro", {"window": 2}),
    "GOPROSynth-expanded": ("gopro", {"window": 2, "expand_boxes": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dataset_items_equal_jax(trees, case):
    """Each dataset class on its tree: every item, JAX's exactly (images
    as uint8, GOPROSynth's average truncated after the clip, boxes
    thresholded and remapped coco80 -> coco91, flow-expanded in float64
    then stored float32)."""
    name = case.split("-")[0]
    tree, kw = CASES[case]
    _same_items(getattr(nat, name)(trees[tree], **kw),
                getattr(jax_nat, name)(trees[tree], **kw))


def test_reds_lists_and_dispatch_equal_jax(trees):
    """REDS from ``segment-reds``'s lists, and ``get_natural_dataset``'s
    table with the keywords ``cli.evaluate`` passes: JAX's items."""
    root = trees["reds"]
    jax_tools.main(["segment-reds", "--root_dir", root])
    _same_items(nat.get_natural_dataset("REDS", root),
                jax_nat.get_natural_dataset("REDS", root))
    for name, tree in (("GOPRO", "gopro"), ("VidBlur", "vidblur"),
                       ("RealBlur", "realblur")):
        assert type(nat.get_natural_dataset(name, trees[tree])).__name__ \
            == name
    with pytest.raises(KeyError):
        nat.get_natural_dataset("GOPROBlurEst", trees["gopro"])


def test_flow_expansion_equals_jax():
    """``expand_boxes_with_flow`` on random boxes and flows, chains of 0-3
    fields each way: JAX's output to the bit (float64 walks, clipped to
    the image)."""
    rng = np.random.default_rng(7)
    boxes = np.zeros((6, 4), np.float32)
    boxes[:, :2] = rng.uniform(-5, 30, (6, 2))
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(1, 20, (6, 2))
    flows = [rng.normal(0, 3, (H, W, 2)).astype(np.float32) for _ in range(6)]
    for nf, nb in ((0, 0), (1, 0), (2, 3), (3, 1)):
        out = nat.expand_boxes_with_flow(boxes, flows[:nf], flows[3:3 + nb],
                                         W, H)
        ref = jax_nat.expand_boxes_with_flow(boxes, flows[:nf],
                                             flows[3:3 + nb], W, H)
        assert out.dtype == ref.dtype and np.array_equal(out, ref)
    p = np.array([3.7, 11.2])
    assert np.array_equal(nat.walk_through_flow(p, flows[:3]),
                          jax_nat.walk_through_flow(p, flows[:3]))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_render_segment_load_equal_jax(trees, tmp_path):
    """``render-gopro-synth`` (window 2, expanded boxes) then
    ``segment-gopro`` of both packages on copies of one tree: the same
    images and targets (bit for bit), the same split lines (paths aside),
    and the rendered set read back by GOPROSynthLoad and GOPROBlurEst
    (train rebalancing from ``default_rng(1337)``) as JAX reads it."""
    out = {}
    for tag, mod in (("ours", tools), ("jax", jax_tools)):
        src = tmp_path / tag / "gopro"
        shutil.copytree(trees["gopro"], src)
        dst = tmp_path / tag / "rendered"
        mod.main(["render-gopro-synth", "--root_dir", str(src),
                  "--output_dir", str(dst), "--window", "2",
                  "--expand_boxes"])
        mod.main(["segment-gopro", "--root_dir", str(dst)])
        out[tag] = dst
    names = sorted(os.listdir(out["jax"] / "blur"))
    assert len(names) == 2 * 5 and names == sorted(
        os.listdir(out["ours"] / "blur"))
    for sub in ("blur", "sharp"):
        for n in sorted(os.listdir(out["jax"] / sub)):
            a, b = out["ours"] / sub / n, out["jax"] / sub / n
            if n.endswith(".png"):
                assert np.array_equal(np.asarray(Image.open(a)),
                                      np.asarray(Image.open(b))), n
            else:
                ta, tb = (pickle.loads(_read(p)) for p in (a, b))
                assert ta.keys() == tb.keys()
                assert all(np.array_equal(ta[k], tb[k]) for k in tb), n
    for split in ("trainSplit.txt", "valSplit.txt"):
        lines = [(out[t] / split).read_text().replace(str(out[t]), "R")
                 for t in ("ours", "jax")]
        assert lines[0] == lines[1] and lines[0].strip()
    _same_items(nat.GOPROSynthLoad(str(out["ours"])),
                jax_nat.GOPROSynthLoad(str(out["jax"])))
    for split in ("train", "val"):
        ours = nat.GOPROBlurEst(str(out["ours"]), split)
        ref = jax_nat.GOPROBlurEst(str(out["jax"]), split)
        assert [(os.path.relpath(p, out["ours"]), lab)
                for p, _, lab in ours.items] == [
            (os.path.relpath(p, out["jax"]), lab) for p, _, lab in ref.items]
        assert ours.class_counts == ref.class_counts
        np.testing.assert_array_equal(ours.class_ratios, ref.class_ratios)
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) for k in b)


def test_segment_reds_equals_jax(trees, tmp_path):
    """``segment-reds`` of both packages: the same kept lists."""
    out = {}
    for tag, mod in (("ours", tools), ("jax", jax_tools)):
        root = tmp_path / tag
        shutil.copytree(trees["reds"], root)
        mod.main(["segment-reds", "--root_dir", str(root)])
        out[tag] = [(root / n).read_text().replace(str(root), "R")
                    for n in ("blurry.txt", "sharp.txt")]
    assert out["ours"] == out["jax"] and out["ours"][0].count("\n") == 3


def test_segment_gopro_faults_not_copied(trees, tmp_path, capsys):
    """The two JAX behaviours the port does not copy (JAX
    ``cli/dataset_tools.py:82`` and ``:99``). A blur image whose ``.dat`` is
    unreadable: JAX writes it into the split as class 2; the port raises
    naming the file. A tree of upper-case ``.PNG`` renders: JAX writes
    empty split files; the port lists every image. A readable ``.dat``
    without a window is class 2 with a warning on both sides."""
    rendered = tmp_path / "rendered"
    tools.main(["render-gopro-synth", "--root_dir", trees["gopro"],
                "--output_dir", str(rendered), "--window", "2"])
    bad = tmp_path / "bad"
    shutil.copytree(rendered, bad)
    (bad / "blur" / "00001.dat").write_bytes(b"not a pickle")
    jax_tools.main(["segment-gopro", "--root_dir", str(bad)])
    labels = {ln.rsplit(",", 1)[0]: int(ln.rsplit(",", 1)[1])
              for n in ("trainSplit.txt", "valSplit.txt")
              for ln in (bad / n).read_text().splitlines() if ln}
    assert labels[str(bad / "blur" / "00001.png")] == 2
    with pytest.raises(ValueError, match="00001.dat"):
        tools.main(["segment-gopro", "--root_dir", str(bad)])

    with open(bad / "blur" / "00001.dat", "wb") as f:
        pickle.dump({"boxes": np.zeros((0, 4), np.float32),
                     "labels": np.zeros(0, np.int32)}, f)
    capsys.readouterr()
    tools.main(["segment-gopro", "--root_dir", str(bad)])
    assert "no windowSize" in capsys.readouterr().out

    upper = tmp_path / "upper"
    shutil.copytree(rendered, upper)
    for p in list(upper.rglob("*.png")):
        p.rename(p.with_suffix(".PNG"))
    n_images = len(list(upper.rglob("*.PNG")))
    jax_tools.main(["segment-gopro", "--root_dir", str(upper)])
    assert all(not (upper / n).read_text().strip()
               for n in ("trainSplit.txt", "valSplit.txt"))
    tools.main(["segment-gopro", "--root_dir", str(upper)])
    written = [ln for n in ("trainSplit.txt", "valSplit.txt")
               for ln in (upper / n).read_text().splitlines() if ln]
    assert len(written) == n_images == 10
    val = nat.GOPROBlurEst(str(upper), "val")
    assert val[0]["image"].shape == (H, W, 3)
