"""The port's benchmark entry points (``detectinblur_tpu_torch/bench/``)
held against the JAX scripts at the repository's root on the CPU, at small
shapes: the serving chain of ``bench.py``, the batch and the step of
``bench_train.py``, the synthetic COCO, the staged batch and the FLOP
count of ``bench_pipeline.py``, each ``main``'s JSON line and the train
script's probes.

Both detectors take JAX's ``model.init(key 0)`` weights (jitted), moved to
the port by ``utils/convert.py::params_from_jax``; the random stages get
JAX's draws (ROADMAP's RNG rule).
"""

import ast
import importlib.util
import json
import math
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse fixture)

from detectinblur_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from detectinblur_tpu.models.faster_rcnn import (
    FasterRCNNConfig as JaxFasterRCNNConfig,
)
from detectinblur_tpu.models.roi_heads import BoxHeadConfig as JaxBoxHeadConfig
from detectinblur_tpu.models.rpn import RPNConfig as JaxRPNConfig
from detectinblur_tpu.ops.blur import batched_blur as jax_batched_blur
from detectinblur_tpu.ops.psf import sample_psf as jax_sample_psf
from detectinblur_tpu.train import engine as jax_engine
from detectinblur_tpu.train import state as jax_state
from detectinblur_tpu_torch.bench import common, pipeline, serve, train
from detectinblur_tpu_torch.models.faster_rcnn import (
    FasterRCNN,
    FasterRCNNConfig,
    LossDraws,
)
from detectinblur_tpu_torch.models.roi_heads import BoxHeadConfig
from detectinblur_tpu_torch.models.rpn import RPNConfig
from detectinblur_tpu_torch.train.state import _freeze_mask
from detectinblur_tpu_torch.utils.convert import params_from_jax

ROOT = pathlib.Path(__file__).resolve().parent.parent
T = torch.from_numpy

# The serving chain: B=2 sources of 96x128 in a 128x128 bucket, with
# test_torch_port_model.py's proposal counts (the CPU's plain RoIAlign
# costs ~3 ms a roi).
SERVE_HW = (96, 128)
SERVE_B = 2
SERVE_SIZES = dict(min_size=96, max_size=128)
SERVE_BUCKET = (128, 128)
SERVE_RPN = dict(pre_nms_top_n_test=400, post_nms_top_n_test=200)
SERVE_BOX = dict(nms_pool=2048)

# The train step, configured as tests/test_torch_port_ddp.py's frozen
# case: every anchor a proposal and every candidate roi sampled on the
# 64x64 bucket, so that float noise cannot change which rois the loss
# sums over (with the top 256 anchors proposed, the step direction of
# box_head.fc6 read 2.8e-3 from JAX's).
TRAIN_HW = (64, 64)
TRAIN_B, TRAIN_G = 1, 4
N_ANCHORS = 3 * (16 * 16 + 8 * 8 + 4 * 4 + 2 * 2 + 1)
RPN_KW = dict(pre_nms_top_n_train=1000, post_nms_top_n_train=N_ANCHORS,
              nms_thresh=1.0)
BOX_KW = dict(batch_size_per_image=N_ANCHORS + 20, positive_fraction=0.5)

# Each main at the smallest shapes that run its whole protocol, with few
# proposals and rois (``light_config``).
TINY = ["--device", "cpu", "--batch", "1", "--height", "64", "--width",
        "64", "--min-size", "64", "--max-size", "64"]
LIGHT_RPN = RPNConfig(pre_nms_top_n_test=100, post_nms_top_n_test=50,
                      pre_nms_top_n_train=100, post_nms_top_n_train=50)
LIGHT_BOX = BoxHeadConfig(batch_size_per_image=32)


def light_config(*args, **kwargs):
    """``common.default_config`` with ``LIGHT_RPN`` and ``LIGHT_BOX``."""
    return common.default_config(*args, **kwargs)._replace(
        rpn=LIGHT_RPN, box=LIGHT_BOX)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: np.clip(x[:, 2:] - x[:, :2], 0, None).prod(-1)
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-9)


@pytest.fixture(scope="module")
def jax_psfs():
    """The serving chain's PSFs as the JAX scripts draw them:
    ``sample_psf`` over ``split(key(1), B)``, expl 0.005, fraction 0.5
    (the train step takes the first)."""
    keys = jax.random.split(jax.random.key(1), SERVE_B)
    return np.array(jax.vmap(
        lambda k: jax_sample_psf(k, expl=0.005, fraction=0.5))(keys))


def _jax_script(name):
    """The JAX script ``name`` at the repository's root, imported with the
    environment it sets at import (``DETECTINBLUR_PRECISION`` and the
    compile cache's variables) restored afterwards."""
    keys = ("DETECTINBLUR_PRECISION", "JAX_COMPILATION_CACHE_DIR",
            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS")
    saved = {k: os.environ.get(k) for k in keys}
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return module


def _jax_keys(name):
    """The keys of the JSON line the JAX script ``name`` prints: the dict
    literal with a "metric" key inside its ``json.dumps`` call."""
    tree = ast.parse((ROOT / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            keys = {k.value for k in node.args[0].keys}
            if "metric" in keys:
                return keys
    raise AssertionError(f"{name}.py prints no metric line")


@pytest.fixture(scope="module")
def jax_params():
    """JAX's ``model.init(key 0)`` (jitted) of ResNet50-FPN, 91 classes."""
    model = JaxFasterRCNN(JaxFasterRCNNConfig())
    return jax.jit(lambda k: model.init(k, bucket=TRAIN_HW))(
        jax.random.key(0))


def _port_weights(jparams):
    return params_from_jax(_np_tree(jparams))


# ------------------------------------------------------------------ serve
def test_serve_chain_matches_jax(jax_params, jax_psfs):
    """The port's timed ``blur_detect`` against ``bench.py:126-130``'s
    chain, both with the RPN delta head zeroed, on the same images,
    jitter and (JAX's) PSFs, in ``highest`` precision:
    test_torch_port_model.py::test_predict_matches_jax's tolerance, 85%
    of JAX's valid detections matched by label, IoU > 0.95 and score
    within 2e-3."""
    jparams = dict(jax_params)
    rh = dict(jparams["rpn_head"])
    rh["bbox_pred"] = {k: jnp.zeros_like(v) for k, v in rh["bbox_pred"].items()}
    jparams["rpn_head"] = rh
    jmodel = JaxFasterRCNN(JaxFasterRCNNConfig(
        rpn=JaxRPNConfig(**SERVE_RPN), box=JaxBoxHeadConfig(**SERVE_BOX),
        **SERVE_SIZES))
    hw = np.tile(np.asarray([SERVE_HW], np.int32), (SERVE_B, 1))
    bucket = serve.model_bucket_for_batch(hw, **SERVE_SIZES)
    assert bucket == SERVE_BUCKET
    images = np.random.default_rng(0).random((SERVE_B, *SERVE_HW, 3),
                                             np.float32)
    psfs = jax_psfs
    jitter = float(np.float32(1e-6 * 3))

    @jax.jit
    def blur_detect(params, images, jitter, hw, psfs, blurring):
        chw = jnp.transpose(images + jitter, (0, 3, 1, 2))
        blurred = jax_batched_blur(chw, psfs, blurring)
        imgs = jnp.transpose(blurred, (0, 2, 3, 1))
        det = jmodel.predict(params, imgs, hw, bucket=bucket)
        return det.boxes, det.scores, det.labels, det.valid

    ref = [np.asarray(a) for a in blur_detect(
        jparams, jnp.asarray(images), jnp.float32(jitter), jnp.asarray(hw),
        jnp.asarray(psfs), jnp.ones(SERVE_B, bool))]

    model = FasterRCNN(FasterRCNNConfig(
        rpn=RPNConfig(**SERVE_RPN), box=BoxHeadConfig(**SERVE_BOX),
        precision="highest", **SERVE_SIZES), device="cpu")
    model.load_state_dict(_port_weights(jax_params))
    serve.zero_rpn_deltas(model)
    got = [a.numpy() for a in serve.blur_detect(
        model, bucket, T(images), jitter, hw, T(psfs),
        torch.ones(SERVE_B, dtype=torch.bool))]
    for b in range(SERVE_B):
        jv, tv = ref[3][b], got[3][b]
        rb, rs, rl = (a[b][jv] for a in ref[:3])
        ob, os_, ol = (a[b][tv] for a in got[:3])
        assert len(rb) > 10 and len(ob) > 10
        ious = _iou(rb, ob) * (rl[:, None] == ol[None, :])
        best = ious.argmax(1)
        ok = ((ious[np.arange(len(rb)), best] > 0.95)
              & (np.abs(rs - os_[best]) < 2e-3))
        assert ok.mean() > 0.85, f"image {b}: {ok.mean():.2%} matched"


# ------------------------------------------------------------------ train
def test_train_batch_is_jax_bit_for_bit():
    """``batch_arrays`` at the protocol's shapes (B=8, G=16, 480x640)
    against ``bench_train.py:66-86``'s draws from ``default_rng(0)``, as
    the arrays JAX stages: equal bit for bit, dtypes included."""
    B, G = 8, 16
    src_h, src_w = 480, 640
    rng = np.random.default_rng(0)
    boxes = np.zeros((B, G, 4), np.float32)
    boxes[..., 0] = rng.uniform(0, src_w // 2, (B, G))
    boxes[..., 1] = rng.uniform(0, src_h // 2, (B, G))
    boxes[..., 2] = boxes[..., 0] + rng.uniform(8, src_w // 3, (B, G))
    boxes[..., 3] = boxes[..., 1] + rng.uniform(8, src_h // 3, (B, G))
    want = dict(
        images=jnp.asarray(rng.random((B, src_h, src_w, 3), np.float32)),
        hw=jnp.tile(jnp.asarray([[src_h, src_w]]), (B, 1)),
        blurring=jnp.ones((B,), bool),
        thetas=jnp.zeros(B),
        lam1s=jnp.full((B,), 0.9),
        lam2s=jnp.full((B,), 0.95),
        param_index=jnp.zeros(B, jnp.int32),
        fraction_index=jnp.ones(B, jnp.int32),
        gt_boxes=jnp.asarray(boxes),
        gt_labels=jnp.asarray(rng.integers(1, 91, (B, G)).astype(np.int32)),
        gt_valid=jnp.asarray(np.ones((B, G), bool)))
    got = train.batch_arrays(B, G, (src_h, src_w))
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _jax_draws(key, B, A, PG):
    """The uniforms ``FasterRCNN.loss(key)`` draws per image, as numpy
    (rpn pos, rpn neg, roi pos, roi neg), each [B, n]: as
    tests/test_torch_port_ddp.py draws them."""
    keys = jax.random.split(key, (B, 2))

    def pair(k, n):
        kp, kn = jax.random.split(k)
        return (np.asarray(jax.random.uniform(kp, (n,))),
                np.asarray(jax.random.uniform(kn, (n,))))

    rpn = [pair(keys[b, 0], A) for b in range(B)]
    roi = [pair(keys[b, 1], PG) for b in range(B)]
    return LossDraws(*(tuple(T(np.stack([p[i] for p in ps])) for i in (0, 1))
                       for ps in (rpn, roi)))


def _jax_trace(opt_state, params):
    """The momentum trace of JAX's SGD (the step direction, gradient plus
    weight decay, after one step) as a tree like ``params``, zeros for
    the frozen tensors."""
    trace, = [s.trace for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    return jax.tree.map(
        lambda p, t: t if isinstance(t, jax.Array) else jnp.zeros_like(p),
        params, trace)


@pytest.fixture(scope="module")
def train_case(jax_params, jax_psfs):
    """JAX's ``bench_train.py`` step (lowered once: its XLA FLOP count,
    then compiled and run on key(100)) and the port's bench step on the
    same weights, batch, PSFs and loss draws, run under
    ``FlopCounterMode`` (``pipeline.step_flops``)."""
    arrays = train.batch_arrays(TRAIN_B, TRAIN_G, TRAIN_HW)
    psfs = jax_psfs[:TRAIN_B]
    sizes = dict(min_size=TRAIN_HW[0], max_size=TRAIN_HW[1])
    jmodel = JaxFasterRCNN(JaxFasterRCNNConfig(
        rpn=JaxRPNConfig(**RPN_KW), box=JaxBoxHeadConfig(**BOX_KW), **sizes))
    tx, _ = jax_state.make_optimizer(base_lr=0.04, steps_per_epoch=1000,
                                     params=jax_params)
    jstep = jax_engine.make_train_step(jmodel, tx, TRAIN_HW, blur_train=True,
                                       expand_target_boxes=True)
    jbatch = jax_engine.BlurBatch(psfs=jnp.asarray(psfs), **{
        k: jnp.asarray(v) for k, v in arrays.items()})
    jst = jax_state.create_train_state(jax.tree.map(jnp.array, jax_params),
                                       tx)
    key = jax.random.key(100)
    lowered = jstep.jitted.lower(jst, None, jbatch, key)
    xla_flops = float(lowered.cost_analysis()["flops"])
    jst, _, jmetrics = lowered.compile()(jst, None, jbatch, key)

    bench = train.setup(TRAIN_B, TRAIN_G, TRAIN_HW, FasterRCNNConfig(
        rpn=RPNConfig(**RPN_KW), box=BoxHeadConfig(**BOX_KW),
        precision="highest", **sizes), device="cpu")
    model, optimizer = bench.model, bench.state.optimizer
    model.load_state_dict(_port_weights(jax_params))
    batch = bench.batch._replace(psfs=T(psfs))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    draws = _jax_draws(jax.random.split(key)[0], TRAIN_B, N_ANCHORS,
                       N_ANCHORS + TRAIN_G)
    (_, metrics), flops = pipeline.step_flops(bench.step, bench.state, batch,
                                              draws=draws)
    direction = {n: optimizer.state[p]["momentum_buffer"].clone()
                 if p in optimizer.state else torch.zeros_like(p)
                 for n, p in model.named_parameters()}
    return dict(
        jax_metrics={k: float(v) for k, v in jmetrics.items()},
        metrics={k: v.item() for k, v in metrics.items()},
        jax_after=params_from_jax(_np_tree(jst.params)),
        jax_direction=params_from_jax(_np_tree(
            _jax_trace(jst.opt_state, jst.params))),
        before=before, after=model.state_dict(), direction=direction,
        mask=_freeze_mask(model), xla_flops=xla_flops, flops=flops)


def _max_rel_errors(got, ref, mask):
    """Per trainable tensor: max |got - ref| over max |ref|."""
    errs = {}
    for name, trainable in mask.items():
        if trainable:
            scale = np.abs(ref[name]).max()
            assert scale > 0, name
            errs[name] = np.abs(got[name] - ref[name]).max() / scale
    worst = max(errs, key=errs.get)
    print(f"max {errs[worst]:.3g} ({worst}), median "
          f"{np.median(list(errs.values())):.3g}")
    return errs


def test_train_step_matches_jax(train_case):
    """One bench step against ``bench_train.py``'s ``make_train_step`` on
    JAX's loss draws, with test_torch_port_ddp.py's tolerances for the
    frozen detector: the losses within 1e-4 relative; each trainable
    tensor's step direction (SGD's momentum after one step: the gradient
    plus weight decay, JAX's optax trace) within 2e-3 of that tensor's
    largest (measured 6.7e-4, box_head.fc6; median 8.8e-5); the frozen tensors unchanged on both sides. The update itself,
    lr 4e-5 (the warmup's first step) times the direction, is ~60 float32
    spacings of a parameter, so each updated parameter is held to the same
    2e-3 of its tensor's largest update plus one float32 spacing of the
    parameter (two roundings of p - lr * d)."""
    c = train_case
    assert set(c["metrics"]) == set(c["jax_metrics"])
    for k, v in c["jax_metrics"].items():
        assert np.isfinite(v), k
        np.testing.assert_allclose(c["metrics"][k], v, rtol=1e-4, err_msg=k)
    for name, trainable in c["mask"].items():
        if not trainable:
            assert torch.equal(c["after"][name], c["before"][name]), name
            assert torch.equal(c["jax_after"][name], c["before"][name]), name
    np_ = lambda d: {k: v.numpy() for k, v in d.items()}
    errs = _max_rel_errors(np_(c["direction"]), np_(c["jax_direction"]),
                           c["mask"])
    assert not {k: v for k, v in errs.items() if not v <= 2e-3}
    for name, trainable in c["mask"].items():
        if not trainable:
            continue
        before, after, ref = (c[k][name].numpy().astype(np.float64)
                              for k in ("before", "after", "jax_after"))
        tol = (2e-3 * np.abs(ref - before).max()
               + np.spacing(np.abs(ref).astype(np.float32)))
        assert (np.abs(after - ref) <= tol).all(), name


# --------------------------------------------------------------- pipeline
def test_flop_count_beside_xla(train_case):
    """The port's ``FlopCounterMode`` count of the train step against
    XLA's ``cost_analysis()["flops"]`` of JAX's same step
    (``bench_pipeline.py:108-129``): measured 0.984. The counter sees the
    convolutions and products only (forward and both backward products);
    XLA counts them alike and also each elementwise operation, reduction
    and the RoIAlign's gather arithmetic, so the ratio is at most 1. The
    products carry all but a few per cent of this step (its 1043 rois
    through the 12544x1024 box head, ResNet50-FPN's convolutions), so it
    is held in [0.95, 1]: a product counted twice or missed on either
    side leaves the band."""
    ratio = train_case["flops"] / train_case["xla_flops"]
    print(f"FLOPs a step: port {train_case['flops']:.6g}, XLA "
          f"{train_case['xla_flops']:.6g}, ratio {ratio:.4f}")
    assert 0.95 <= ratio <= 1.0


def test_synthetic_coco_is_jax_byte_for_byte(tmp_path, monkeypatch):
    """``synth_coco_dir`` against ``bench_pipeline.synth_coco_dir`` with
    ``N_IMAGES`` 6, both from ``default_rng(0)``: the same index and
    byte-equal JPEGs."""
    jax_bench = _jax_script("bench_pipeline")
    monkeypatch.setattr(jax_bench, "N_IMAGES", 6)
    jdir, jann = jax_bench.synth_coco_dir(str(tmp_path / "jax"),
                                          np.random.default_rng(0))
    pdir, pann = pipeline.synth_coco_dir(str(tmp_path / "port"),
                                         np.random.default_rng(0), 6)
    assert pann == jann and len(pann["images"]) == 6
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir)) and len(names) == 6
    for n in names:
        assert ((pathlib.Path(pdir) / n).read_bytes()
                == (pathlib.Path(jdir) / n).read_bytes()), n


def test_build_batch_matches_jax():
    """``_build_batch(gt_count)`` against ``bench_pipeline._build_batch``
    field by field at the protocol's shapes: equal values (the port's
    labels are int64 by design, JAX's int32)."""
    jax_bench = _jax_script("bench_pipeline")
    ref = jax_bench._build_batch(8)
    got = pipeline._build_batch(8)
    for name in ref._fields:
        r = getattr(ref, name)
        if r is None:
            continue
        g = getattr(got, name).numpy()
        r = np.asarray(r)
        assert g.shape == r.shape, name
        if name != "gt_labels":
            assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


# ------------------------------------------------------------------ mains
@pytest.mark.parametrize("name,module,argv", [
    ("bench", serve, ["--iters", "2", "--repeats", "1"]),
    ("bench_train", train, ["--gt", "2", "--iters", "1", "--repeats", "1"]),
    ("bench_pipeline", pipeline, ["--step-iters", "1",
                                  "--loader-batches", "1"]),
], ids=["serve", "train", "pipeline"])
def test_main_prints_the_jax_line(name, module, argv, capsys, monkeypatch):
    """``main`` with ``--device cpu`` and the small flags (and the light
    model config): the last line of stdout is one JSON object with exactly
    the JAX script's keys, and it is the only JSON line there; ``value``
    is finite and > 0."""
    monkeypatch.setattr(module, "default_config", light_config)
    monkeypatch.setenv("BENCH_N_IMAGES", "3")
    monkeypatch.setenv("BENCH_WORKERS", "2")
    record = module.main(TINY + argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == record
    assert not any(line.startswith("{") for line in lines[:-1])
    assert set(record) == _jax_keys(name)
    assert math.isfinite(record["value"]) and record["value"] > 0
    if name == "bench_pipeline":
        assert record["device_kind"] == "cpu" and record["flops_per_step"] > 0
        assert record["loader_only_img_s"] > 0 and record["mfu"] > 0


@pytest.mark.parametrize("module", [serve, train, pipeline],
                         ids=["serve", "train", "pipeline"])
def test_main_without_a_card_raises(module):
    """With no ``--device`` on a machine without a card: the "no CUDA
    device" error, never a quiet run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


# ----------------------------------------------------------------- probes
PROBE_CONFIG = FasterRCNNConfig(min_size=64, max_size=64, rpn=LIGHT_RPN,
                                box=LIGHT_BOX, precision="highest")


def _probe_bench(monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return train.setup(1, 2, TRAIN_HW, PROBE_CONFIG, "cpu",
                       train.read_probes())


def test_probe_zero_rpn_delta(monkeypatch):
    """``DIB_ZERO_RPN_DELTA=1`` zeroes the RPN delta head."""
    head = _probe_bench(monkeypatch,
                        DIB_ZERO_RPN_DELTA="1").model.rpn_head.bbox_pred
    assert not head.weight.any() and not head.bias.any()


def test_probe_post_nms_train(monkeypatch):
    """``DIB_POST_NMS_TRAIN=512`` reaches the model's RPN config; the
    other probes stay off (the RPN delta head random)."""
    assert train.read_probes({}) == train.Probes()
    bench = _probe_bench(monkeypatch, DIB_POST_NMS_TRAIN="512")
    assert bench.model.cfg.rpn.post_nms_top_n_train == 512
    assert bench.model.rpn_head.bbox_pred.weight.any() and bench.held is None


def test_probe_hold_state(monkeypatch):
    """``DIB_HOLD_STATE=1``: every timed step starts from the held
    parameters and momentum buffers (each step does move them), and the
    state's step count stays 0."""
    bench = _probe_bench(monkeypatch, DIB_HOLD_STATE="1")
    optimizer = bench.state.optimizer
    params = [p for g in optimizer.param_groups for p in g["params"]]
    live = lambda: [t.detach().clone() for t in params + [
        optimizer.state[p]["momentum_buffer"] for p in params]]
    start, entries = live(), []

    def spy(state, batch, **kwargs):
        entries.append(live())
        return bench.step(state, batch, **kwargs)

    held = bench._replace(step=spy)
    generator = torch.Generator().manual_seed(100)
    state = bench.state
    for _ in range(2):
        state, metrics = train.bench_step(held, state, generator)
        assert state.step == 0 and torch.isfinite(metrics["loss"])
        assert not all(torch.equal(a, b) for a, b in zip(live(), start))
    assert len(entries) == 2
    for seen in entries:
        assert all(torch.equal(a, b) for a, b in zip(seen, start))
