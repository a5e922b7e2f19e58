"""The port's data parallelism on the CPU: processes in a gloo group, each
spawned from ``tests/ddp_workers.py`` (no JAX in them), held against the
JAX package's own multi-device step and against the port in one process.

The promise JAX keeps on its mesh (``tests/test_multichip_step.py``): the
step over a batch sharded on W devices is the step on the whole global
batch. Here W = 2 processes, each with its image of a global batch of 2
and its rows of JAX's per-image draws, against ``make_mesh(2)`` +
``replicate`` + ``shard_batch`` + ``make_train_step`` on two of conftest's virtual CPU
devices. The detector is ResNet50-FPN at full widths on a 64x64 bucket,
configured as ``tests/test_torch_port_train.py``'s two-step case: every
anchor a proposal and every candidate roi sampled, so that float noise
cannot change which rois the loss sums over. The multichip test's reduced
counts (100 proposals, 64 rois) would let that noise reorder the
proposals between the frameworks. With a roi budget above the candidates,
the roi quota runs short on every image, and the images' counts differ
(their valid GT boxes do): the losses must divide by the global batch's
counts, not each process's.
"""

import contextlib
import shutil
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ddp_workers as dw
from remedy_helpers import np_tree, resnet18_sd
from synthetic_coco import write_coco
from torch_reference import make_random_fasterrcnn_sd
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

from detectinblur_tpu.models import classifier as jax_cls
from detectinblur_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from detectinblur_tpu.models.faster_rcnn import (
    FasterRCNNConfig as JaxFasterRCNNConfig,
)
from detectinblur_tpu.models.roi_heads import BoxHeadConfig as JaxBoxHeadConfig
from detectinblur_tpu.models.rpn import RPNConfig as JaxRPNConfig
from detectinblur_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from detectinblur_tpu.train import engine as jax_engine
from detectinblur_tpu.train import estimator_engine as jax_est
from detectinblur_tpu.train import state as jax_state
from detectinblur_tpu.utils.torch_convert import (
    convert_fasterrcnn_bn_stats,
    convert_fasterrcnn_state_dict,
    convert_resnet_classifier_state_dict,
)
import detectinblur_tpu_torch.cli.evaluate as cli_eval
from detectinblur_tpu_torch.data.blur_sampling import BlurPolicy
from detectinblur_tpu_torch.data.loader import DetectionLoader, steps_together
from detectinblur_tpu_torch.models import faster_rcnn
from detectinblur_tpu_torch.models.classifier import ResNetClassifier
from detectinblur_tpu_torch.models.faster_rcnn import (
    FasterRCNN,
    FasterRCNNConfig,
    LossDraws,
)
from detectinblur_tpu_torch.models.roi_heads import BoxHeadConfig
from detectinblur_tpu_torch.models.rpn import RPNConfig
from detectinblur_tpu_torch.parallel import dist as pdist
from detectinblur_tpu_torch.train import engine, state
from detectinblur_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from detectinblur_tpu_torch.train.estimator_engine import (
    make_estimator_train_step,
)
from detectinblur_tpu_torch.train.state import TrainState, make_lr_schedule
from detectinblur_tpu_torch.utils.convert import (
    classifier_params_from_jax,
    params_from_jax,
)

T = torch.from_numpy
W = 2
BUCKET = (64, 64)
N_ANCHORS = 3 * (16 * 16 + 8 * 8 + 4 * 4 + 2 * 2 + 1)
G = 4
RPN_KW = dict(pre_nms_top_n_train=1000, post_nms_top_n_train=N_ANCHORS,
              nms_thresh=1.0)
BOX_KW = dict(batch_size_per_image=N_ANCHORS + 20, positive_fraction=0.5)
HW = np.array([[64, 64], [56, 60]], np.int32)
EST_SRC = (64, 96)
EST_HW = np.array([[64, 96], [56, 80]], np.int32)


def _rows(tree, r):
    """Rank r's rows of each array of ``tree`` (a dict or a tuple)."""
    n = len(HW) // W
    sl = slice(r * n, (r + 1) * n)
    if isinstance(tree, dict):
        return {k: v[sl] for k, v in tree.items()}
    return tuple(v[sl] for v in tree)


def _jax_draws(key, B, A, PG):
    """The uniforms ``FasterRCNN.loss(key)`` draws per image, as numpy
    (rpn pos, rpn neg, roi pos, roi neg), each [B, n]."""
    keys = jax.random.split(key, (B, 2))

    def pair(k, n):
        kp, kn = jax.random.split(k)
        return (np.asarray(jax.random.uniform(kp, (n,))),
                np.asarray(jax.random.uniform(kn, (n,))))

    rpn = [pair(keys[b, 0], A) for b in range(B)]
    roi = [pair(keys[b, 1], PG) for b in range(B)]
    return tuple(np.stack([p[i] for p in ps]) for ps in (rpn, roi)
                 for i in (0, 1))


def _loss_draws(d):
    return LossDraws(rpn=(T(d[0]), T(d[1])), roi=(T(d[2]), T(d[3])))


def _detector_batch():
    rng = np.random.default_rng(6)
    images = rng.random((len(HW), 64, 64, 3), dtype=np.float32)
    psfs = np.zeros((len(HW), 128, 128), np.float32)
    psfs[:, 58:70, 60:67] = rng.random((len(HW), 12, 7))
    gt = np.zeros((len(HW), G, 4), np.float32)
    for b, (h, w) in enumerate(HW):
        gt[b, :, :2] = rng.uniform(0, min(h, w) * 0.6, (G, 2))
        gt[b, :, 2:] = gt[b, :, :2] + rng.uniform(10, min(h, w) * 0.5, (G, 2))
    valid = np.ones((len(HW), G), bool)
    valid[0, -1] = False
    valid[1, 1:] = False
    return dict(images=images, hw=HW, psfs=psfs,
                blurring=np.array([True, False]), gt_boxes=gt,
                gt_labels=rng.integers(1, 5, (len(HW), G)).astype(np.int64),
                gt_valid=valid)


def _digests_equal(a: Dict[str, str], b: Dict[str, str]) -> bool:
    return a.keys() == b.keys() and all(a[k] == b[k] for k in a)


@contextlib.contextmanager
def _recording(module, name, calls):
    """``module.name`` records each call's outputs in ``calls``."""
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(tuple(t.detach().clone() for t in out))
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _detector_case(tmp, name, bn_mode, keys, lr, steps_per_epoch):
    """JAX's 2-device sharded steps and the port's one-process steps on
    the global batch, and the W=2 case for the workers."""
    sd = make_random_fasterrcnn_sd(np.random.default_rng(1), num_classes=5)
    frozen = bn_mode is None
    jparams = convert_fasterrcnn_state_dict(sd, frozen_bn=frozen)
    jstats = None if frozen else convert_fasterrcnn_bn_stats(
        sd, num_batches=16.0)
    common = dict(num_classes=5, min_size=BUCKET[0], max_size=BUCKET[1],
                  bn_mode=bn_mode)
    jmodel = JaxFasterRCNN(JaxFasterRCNNConfig(
        rpn=JaxRPNConfig(**RPN_KW), box=JaxBoxHeadConfig(**BOX_KW), **common))
    weights = params_from_jax(np_tree(jparams), 5, batch_stats=None if frozen
                              else np_tree(jstats))
    flags = dict(blur_train=True, expand_target_boxes=True)
    batch = _detector_batch()

    tx, _ = jax_state.make_optimizer(base_lr=lr,
                                     steps_per_epoch=steps_per_epoch,
                                     params=jparams)
    jstep = jax_engine.make_train_step(jmodel, tx, BUCKET, **flags)
    jbatch = jax_engine.BlurBatch(
        thetas=None, lam1s=None, lam2s=None, param_index=None,
        fraction_index=None, **{k: jnp.asarray(v) for k, v in batch.items()})
    jmetrics = []
    with make_mesh(W) as mesh:
        jst = jax_state.create_train_state(jax.tree.map(jnp.array, jparams),
                                           tx)
        jst = jst._replace(params=replicate(mesh, jst.params),
                           opt_state=replicate(mesh, jst.opt_state))
        sbatch = shard_batch(mesh, jbatch)
        if not frozen:
            jstats = replicate(mesh, jax.tree.map(jnp.array, jstats))
        for k in keys:
            if frozen:
                jst, m = jstep(jst, sbatch, k)
            else:
                jst, jstats, m = jstep(jst, jstats, sbatch, k)
            jmetrics.append({n: float(v) for n, v in m.items()})
    jax_after = params_from_jax(np_tree(jst.params), 5,
                                batch_stats=None if frozen
                                else np_tree(jstats))

    cfg = dict(common, rpn=RPN_KW, box=BOX_KW)
    model = FasterRCNN(FasterRCNNConfig(
        rpn=RPNConfig(**RPN_KW), box=BoxHeadConfig(**BOX_KW),
        precision="highest", **common), device="cpu")
    model.load_state_dict(weights)
    opt, sched = state.make_optimizer(model, base_lr=lr,
                                      steps_per_epoch=steps_per_epoch)
    st = state.create_train_state(model, opt)
    start = str(tmp / f"{name}_start")
    resume = save_checkpoint(start, st, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    draws = [_jax_draws(jax.random.split(k)[0], len(HW), N_ANCHORS,
                        N_ANCHORS + G) for k in keys]
    step = engine.make_train_step(model, sched, BUCKET, **flags)
    tbatch = engine.BlurBatch(**{k: T(v) for k, v in batch.items()})
    w1, head_sums = [], []
    for d in draws:
        with _recording(faster_rcnn, "fastrcnn_loss", head_sums):
            st, m = step(st, tbatch, draws=_loss_draws(d))
        w1.append({n: v.item() for n, v in m.items()})
    rank_cases = [dict(kind="detector", config=cfg, optimizer=dict(
                           base_lr=lr, steps_per_epoch=steps_per_epoch),
                       bucket=BUCKET, flags=flags, resume=resume,
                       batch=_rows(batch, r),
                       draws=[_rows(d, r) for d in draws])
                  for r in range(W)]
    return dict(jax_metrics=jmetrics, jax_after=jax_after, w1_metrics=w1,
                w1_after=model.state_dict(), before=before,
                mask=state._freeze_mask(model), head_sums=head_sums,
                rank_cases=rank_cases)


LR, WD = 0.01, 1e-4


def _estimator_case(tmp):
    """The LEHE estimator step (label smoothing 0.1) on 2 images of the
    64x96 bucket: JAX's 2-device sharded step, the port's one-process
    step and the W=2 case."""
    sd = resnet18_sd(4, seed=1)
    params, stats = convert_resnet_classifier_state_dict(sd, include_fc=True)
    weights = classifier_params_from_jax(np_tree(params), np_tree(stats),
                                         num_classes=4)
    rng = np.random.default_rng(9)
    B = len(EST_HW)
    images = np.zeros((B, *EST_SRC, 3), np.float32)
    for b, (h, w) in enumerate(EST_HW):
        images[b, :h, :w] = rng.random((h, w, 3))
    psfs = np.zeros((B, 128, 128), np.float32)
    psfs[:, 58:70, 60:66] = rng.random((B, 12, 6))
    batch = dict(images=images, hw=EST_HW, psfs=psfs,
                 blurring=np.array([True, False]),
                 param_index=np.array([1, -1], np.int32),
                 fraction_index=np.array([3, -1], np.int32),
                 gt_boxes=np.zeros((B, 2, 4), np.float32),
                 gt_labels=np.zeros((B, 2), np.int64),
                 gt_valid=np.zeros((B, 2), bool),
                 est_label=np.full(B, -1, np.int32))
    kw = dict(lehe=True, label_smoothing=0.1)

    tx = optax.chain(optax.add_decayed_weights(WD),
                     optax.sgd(jax_state.make_lr_schedule(
                         LR, 1, milestones=(6, 8)), momentum=0.9))
    jmodel = jax_cls.ResNetClassifier("resnet18", 4, "train")
    jstep = jax_est.make_estimator_train_step(jmodel, tx, EST_SRC, **kw)
    jbatch = jax_engine.BlurBatch(
        thetas=jnp.zeros(B), lam1s=jnp.ones(B), lam2s=jnp.ones(B),
        **{k: jnp.asarray(v) for k, v in batch.items()})
    with make_mesh(W) as mesh:
        jst = replicate(mesh, jax_state.TrainState(
            jnp.int32(0), jax.tree.map(jnp.array, params), tx.init(params)))
        jst, jstats, jm = jstep(jst, replicate(mesh, jax.tree.map(
            jnp.array, stats)), shard_batch(mesh, jbatch), jax.random.key(11))
    jax_after = classifier_params_from_jax(np_tree(jst.params),
                                           np_tree(jstats), num_classes=4)

    model = ResNetClassifier("resnet18", 4, "train", precision="highest",
                             device="cpu")
    model.load_state_dict(weights)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9,
                          weight_decay=WD)
    st = TrainState(0, model, opt)
    resume = save_checkpoint(str(tmp / "est_start"), st, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_estimator_train_step(
        model, make_lr_schedule(LR, 1, milestones=(6, 8)), EST_SRC, **kw)
    st, m = step(st, engine.BlurBatch(**{k: T(v) for k, v in batch.items()}))
    rank_cases = [dict(kind="estimator", num_classes=4,
                       optimizer=dict(lr=LR, weight_decay=WD),
                       bucket=EST_SRC, flags=kw, resume=resume,
                       batch=_rows(batch, r), draws=[None])
                  for r in range(W)]
    return dict(jax_metrics=[{k: float(v) for k, v in jm.items()}],
                jax_after=jax_after,
                w1_metrics=[{k: v.item() for k, v in m.items()}],
                w1_after=model.state_dict(), before=before,
                mask={n: True for n, _ in model.named_parameters()},
                rank_cases=rank_cases)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Each case's references and its two ranks' results, from one pair
    of spawned processes: the frozen detector (two steps, warmup then
    lr 0.04), train-mode BatchNorm (one step at lr 0.02) and the
    estimator (one step)."""
    tmp = tmp_path_factory.mktemp("ddp_steps")
    try:
        yield _built_cases(tmp)
    finally:   # ~1 GB of checkpoints
        shutil.rmtree(tmp, ignore_errors=True)


def _built_cases(tmp):
    built = {
        "frozen": _detector_case(tmp, "frozen", None,
                                 [jax.random.key(11), jax.random.key(12)],
                                 0.04, 2),
        "bn": _detector_case(tmp, "bn", "train", [jax.random.key(21)], 0.02,
                             1),
        "estimator": _estimator_case(tmp),
    }
    port = dw.free_port()
    ranks = dw.spawn(dw.train_cases, [
        dict(port=port, out=str(tmp / "w2"),
             cases=[c["rank_cases"][r] for c in built.values()])
        for r in range(W)], timeout=600)
    for i, c in enumerate(built.values()):
        c["ranks"] = [ranks[r][i] for r in range(W)]
        c["w2_checkpoint"] = tmp / "w2" / "rank0" / str(i) / "model_0.pt"
    return built


def _update_errors(after, ref_after, before, mask):
    """Per trainable tensor: max |update - reference update| over the
    reference update's largest magnitude; frozen tensors unchanged on
    both sides."""
    errs = {}
    for name, trainable in mask.items():
        upd = (after[name] - before[name]).numpy()
        ref = (ref_after[name] - before[name]).numpy()
        if not trainable:
            assert not upd.any() and not ref.any(), name
            continue
        scale = np.abs(ref).max()
        assert scale > 0, name
        errs[name] = np.abs(upd - ref).max() / scale
    return errs


def _print_errors(what, errs):
    """The readings behind the update tolerances (``pytest -s``)."""
    worst = max(errs, key=errs.get)
    print(f"{what}: update errors max {errs[worst]:.3g} ({worst}), median "
          f"{np.median(list(errs.values())):.3g}")


def _w2_after(case):
    return torch.load(case["w2_checkpoint"], weights_only=True)["model"]


def _check_ranks(case):
    """Both ranks report the same global metrics and bit-identical
    parameters and buffers after every step; every trainable parameter
    got a gradient on every step (DDP needs no
    ``find_unused_parameters``)."""
    r0, r1 = case["ranks"]
    assert r0["metrics"] == r1["metrics"]
    for a, b in zip(r0["digests"], r1["digests"]):
        assert _digests_equal(a, b)
    assert r0["no_grad"] == r1["no_grad"] == []


@pytest.mark.parametrize("name", ["frozen", "bn", "estimator"])
def test_w2_step_matches_jax_sharded_step(cases, name):
    """The W=2 step against JAX's 2-device sharded step on the global
    batch: the losses within 1e-4 relative (the estimator's within 1e-5
    and its top-1 equal), the running statistics within 1e-4 of each
    tensor's magnitude (measured 2.3e-6), the ranks identical. Each
    trainable tensor's update within 2e-3 of that tensor's largest
    update for the frozen detector (measured 8.5e-4) and the estimator
    (3.5e-4). Under train-mode BatchNorm the update is ill-conditioned at
    this size (layer4's statistics cover 2 images of 2x2): the port's
    one-process step itself lands up to 0.32 from JAX's
    (layer4_1.conv3). There each tensor is held within 5e-3 beyond the
    one-process step's own distance from JAX (W=2 and W=1 differ by up
    to 4.5e-3), and the median over tensors within 2e-2 (measured
    9.1e-3)."""
    case = cases[name]
    _check_ranks(case)
    metrics = case["ranks"][0]["metrics"]
    assert len(metrics) == len(case["jax_metrics"])
    for got, want in zip(metrics, case["jax_metrics"]):
        assert set(got) == set(want)
        for k, v in want.items():
            assert np.isfinite(v), k
            if k == "top1":
                assert got[k] == v
            else:
                rtol = 1e-5 if name == "estimator" else 1e-4
                np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)
    after = _w2_after(case)
    errs = _update_errors(after, case["jax_after"], case["before"],
                          case["mask"])
    _print_errors(f"{name} W=2 against JAX's 2-device step", errs)
    if name == "bn":
        own = _update_errors(case["w1_after"], case["jax_after"],
                             case["before"], case["mask"])
        _print_errors(f"{name} W=1 against JAX's 2-device step", own)
        assert not {k: (v, own[k]) for k, v in errs.items()
                    if not v <= own[k] + 5e-3}
        assert np.median(list(errs.values())) <= 2e-2
    else:
        assert not {k: v for k, v in errs.items() if not v <= 2e-3}
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert bool(stats) == (name != "frozen")
    for k in stats:
        r = case["jax_after"][k].numpy()
        assert not torch.equal(after[k], case["before"][k]), k
        assert np.abs(after[k].numpy() - r).max() <= 1e-4 * np.abs(r).max(), k


@pytest.mark.parametrize("name", ["frozen", "bn", "estimator"])
def test_w2_step_matches_one_process_step(cases, name):
    """The W=2 step against the port's one-process step on the global
    batch: the losses within 1e-5 relative (measured 3e-7), the running
    statistics within 1e-5 of their magnitude (1.4e-6); each update
    within 2e-2 of its tensor's largest and their median within 5e-3.
    The reduction (DDP's average of W x each process's share of the
    global sums, BatchNorm's sums over both processes) is the one-process
    gradient up to float32 sums in another order, and that noise is
    large where the gradient is ill-conditioned: measured at most 1.0e-2
    (frozen, layer3_0.conv3, where the one-process step is as far from
    JAX's sharded step), 4.5e-3 (BatchNorm) and 3.5e-4 (estimator),
    medians 5.5e-5, 1.8e-3 and 1.2e-5 (printed under ``pytest -s``)."""
    case = cases[name]
    for got, want in zip(case["ranks"][0]["metrics"], case["w1_metrics"]):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    after = _w2_after(case)
    errs = _update_errors(after, case["w1_after"], case["before"],
                          case["mask"])
    _print_errors(f"{name} W=2 against one process", errs)
    assert not {k: v for k, v in errs.items() if not v <= 2e-2}
    assert np.median(list(errs.values())) <= 5e-3
    for k in after:
        if k.endswith(("running_mean", "running_var")):
            r = case["w1_after"][k].numpy()
            assert (np.abs(after[k].numpy() - r).max()
                    <= 1e-5 * np.abs(r).max()), k


def test_global_counts_decide_the_losses(cases):
    """The case the global counts exist for: the roi quota runs short and
    the two images sample different numbers of rois, so the mean of each
    process's head losses over its own count is not the global batch's
    loss (the sums over the global count), which the W=2 step gives
    (above). The sums and counts are those of the one-process step's
    ``fastrcnn_loss``."""
    case = cases["frozen"]
    for (ce, box, n), m in zip(case["head_sums"], case["w1_metrics"]):
        assert n.tolist()[0] != n.tolist()[1] and n.max() < BOX_KW[
            "batch_size_per_image"], n
        for sums, k in ((ce, "loss_classifier"), (box, "loss_box_reg")):
            whole = (sums.sum() / n.sum()).item()
            own = (sums / n).mean().item()
            np.testing.assert_allclose(whole, m[k], rtol=1e-6)
            assert abs(own - whole) > 1e-2 * whole, k


@pytest.mark.parametrize("name", ["frozen", "bn", "estimator"])
def test_checkpoints_cross_process_counts(cases, name):
    """Each W=2 case resumed from a checkpoint written in one process,
    and process 0 alone wrote the W=2 checkpoint, which restores in one
    process bit for bit (weights, statistics, momentum, step)."""
    case = cases[name]
    ranks = case["ranks"]
    assert ranks[0]["files"] == ["model_0.pt"] and ranks[1]["files"] == []
    if name == "estimator":
        model = ResNetClassifier("resnet18", 4, "train", precision="highest",
                                 device="cpu")
        opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9,
                              weight_decay=WD)
    else:
        model = FasterRCNN(FasterRCNNConfig(
            num_classes=5, min_size=64, max_size=64, rpn=RPNConfig(**RPN_KW),
            box=BoxHeadConfig(**BOX_KW), precision="highest",
            bn_mode=None if name == "frozen" else "train"), device="cpu")
        opt, _ = state.make_optimizer(model)
    st = restore_checkpoint(str(case["w2_checkpoint"]),
                            TrainState(0, model, opt))
    assert st.step == len(case["jax_metrics"])
    got = dw.digests(model, opt)
    assert any(k.startswith("momentum.") for k in got)
    assert _digests_equal(got, ranks[0]["digests"][-1])


# ------------------------------------------------------- the group itself
@pytest.mark.parametrize("case", ["no-launcher", "launcher", "without",
                                  "mismatch"])
def test_launch_env(case):
    """No launcher's environment is one process; ``--world-size`` > 1
    without it raises, naming torchrun; a count that disagrees with the
    launcher's raises; the launcher's gives rank, count and local rank."""
    env = dict(RANK="3", WORLD_SIZE="4", LOCAL_RANK="1")
    if case == "no-launcher":
        assert pdist.launch_env(1, {}) is None
    elif case == "launcher":
        assert pdist.launch_env(1, env) == (3, 4, 1)
        assert pdist.launch_env(4, env) == (3, 4, 1)
        assert pdist.launch_env(1, dict(RANK="2", WORLD_SIZE="4")) == (2, 4, 2)
    elif case == "without":
        with pytest.raises(RuntimeError,
                           match="torchrun --nproc_per_node 2"):
            pdist.launch_env(2, {})
    else:
        with pytest.raises(ValueError, match="WORLD_SIZE=4"):
            pdist.launch_env(2, env)


def test_rank_device():
    """Under a group plain ``cuda`` is the local rank's card; ``cuda:K``
    (ranks sharing a card) and ``cpu`` stay as given."""
    assert pdist.rank_device("cuda", 3) == torch.device("cuda", 3)
    assert pdist.rank_device("cuda:0", 3) == torch.device("cuda", 0)
    assert pdist.rank_device(torch.device("cpu"), 1) == torch.device("cpu")


def test_helpers_without_a_group_and_an_existing_group(tmp_path):
    """Without a group every helper is the identity and nothing is
    wrapped; in a group the caller initialized, ``init_distributed`` uses
    it as it is (and leaves it to the caller), and the helpers run."""
    import argparse

    import torch.distributed as dist

    t = torch.arange(3.0)
    assert pdist.all_reduce_sum(t) is t
    assert pdist.agree_max([3, 5]) == (3, 5)
    assert pdist.all_have(False) is False
    pdist.barrier()
    loader = [1, 2]
    assert steps_together(loader) is loader
    model = torch.nn.Linear(2, 2)
    assert pdist.data_parallel(model) is None
    args = argparse.Namespace(world_size=1, dist_url="env://")
    assert pdist.init_distributed(args, "cpu") is False
    assert not pdist.distributed()

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{dw.free_port()}", world_size=1, rank=0)
    try:
        assert pdist.init_distributed(args, "cpu") is False
        with pytest.raises(ValueError, match="1 processes"):
            pdist.init_distributed(argparse.Namespace(
                world_size=2, dist_url="env://"), "cpu")
        assert pdist.distributed() and pdist.process_count() == 1
        assert pdist.agree_max([3, 5]) == (3, 5)
        assert pdist.all_have(True) is True
        ddp = pdist.data_parallel(model)
        assert ddp is pdist.data_parallel(model)
        assert list(model.state_dict()) == ["weight", "bias"]
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- the CLIs
SIZES = {
    # 7 images of both orientations: the two shards of 4 (one padded)
    # make different numbers of batches of 2 (see the CLI test).
    "train2017": [(72, 96), (96, 72), (64, 96), (72, 80), (96, 64),
                  (64, 88), (72, 96)],
    "val2017": [(72, 96), (96, 72), (64, 96), (96, 64), (72, 88),
                (88, 72)],
}


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """The three CLIs at W=2 in two spawned processes, as torchrun starts
    them, on a synthetic COCO; ``cli.evaluate`` from a random .pth whose
    detections score."""
    tmp = tmp_path_factory.mktemp("ddp_clis")
    try:
        yield _run_clis(tmp)
    finally:   # ~0.5 GB of weights and checkpoints
        shutil.rmtree(tmp, ignore_errors=True)


def _run_clis(tmp):
    root = write_coco(str(tmp / "coco"), SIZES, seed=1, n_cats=4,
                      boxes=(2, 5), box_frac=(0.4, 0.9))
    sd = make_random_fasterrcnn_sd(np.random.default_rng(0), num_classes=5)
    pth = str(tmp / "tiny.pth")
    torch.save({k: T(v) for k, v in sd.items()}, pth)
    argv = dict(
        train=["--blur_train", "--expand_target_boxes", "-b", "2",
               "--epochs", "1", "--lr", "0.001", "--print-freq", "1"],
        evaluate=["--resume", pth, "--vanilla_eval"],
        estimator=["--LEHE_blur_seg", "-b", "2", "--epochs", "1",
                   "--print-freq", "1"])
    ports = [dw.free_port() for _ in range(3)]
    ranks = dw.spawn(dw.run_clis, [
        dict(coco=root, out=str(tmp / "out"), ports=ports, **argv)
        for _ in range(W)], timeout=600)
    return dict(root=root, pth=pth, out=tmp / "out", ranks=ranks)


def _batch_counts(root, monkeypatch):
    """Each rank's batches of 2 in cli.train's first epoch."""
    from detectinblur_tpu_torch.data import batching
    from detectinblur_tpu_torch.data.coco import get_coco

    monkeypatch.setattr(batching, "DEFAULT_SOURCE_BUCKETS",
                        dw.SOURCE_BUCKETS)
    ds = get_coco(root, "train")
    return [sum(1 for _ in DetectionLoader(ds, 2, BlurPolicy(prob=0.0),
                                           shuffle=True, num_processes=W,
                                           process_index=r))
            for r in range(W)]


def test_cli_train_w2_ends_the_epoch_together(clis, monkeypatch):
    """``cli.train`` at W=2 whose ranks' shards make 1 and 2 batches (each
    source bucket drops its leftovers): both end the epoch after 1 step,
    without a hang, with the same global losses and bit-identical models;
    only rank 0 writes ``model_0.pt``, which restores in one process bit
    for bit; both ranks hold the same merged eval stats."""
    counts = _batch_counts(clis["root"], monkeypatch)
    assert sorted(counts) == [1, 2], counts
    r0, r1 = (r["train"] for r in clis["ranks"])
    assert r0["step"] == r1["step"] == 1
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 1
    assert all(np.isfinite(v) for v in r0["losses"][0].values())
    assert _digests_equal(r0["digests"], r1["digests"])
    assert "model_0.pt" in r0["files"] and r1["files"] == []
    assert sorted(r0["evals"]) == ["Blurred/0", "Normal/0"]
    for k, v in r0["evals"].items():
        np.testing.assert_array_equal(v, r1["evals"][k])
        assert v.shape == (19,) and np.isfinite(v).all()
    for mod, name, value in dw.tiny_patches():
        monkeypatch.setattr(mod, name, value)
    model = dw.build_tiny(None, "cpu")
    opt, _ = state.make_optimizer(model, base_lr=0.001)
    st = restore_checkpoint(str(clis["out"] / "train_rank0" / "model_0.pt"),
                            state.create_train_state(model, opt))
    assert st.step == 1
    assert _digests_equal(dw.digests(model), r0["digests"])


def test_cli_evaluate_w2_gives_the_one_process_stats(clis, monkeypatch):
    """``cli.evaluate`` clean at W=2 (3 images a rank, merged) gives the
    19 stats of the same eval in one process exactly, on both ranks."""
    for mod, name, value in dw.tiny_patches():
        monkeypatch.setattr(mod, name, value)
    w1 = cli_eval.main(["--data-path", clis["root"], "--device", "cpu",
                        "--resume", clis["pth"], "--vanilla_eval",
                        "--workers", "0"])
    assert w1.shape == (19,) and np.isfinite(w1).all() and w1[8] >= 0
    for r in clis["ranks"]:
        np.testing.assert_array_equal(r["evaluate"]["stats"], w1)


def test_cli_estimator_w2_trains_and_rank0_writes(clis):
    """``cli.train_blur_estimator --LEHE_blur_seg`` at W=2 on
    ``cli.train``'s shards of 1 and 2 batches: both ranks end the epoch
    after 1 step with the same global metrics and bit-identical models,
    the eval's accuracies come from both ranks' rows, and only rank 0
    writes ``model_0.pt``."""
    r0, r1 = (r["estimator"] for r in clis["ranks"])
    assert r0["step"] == r1["step"] == 1
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 1
    assert all(np.isfinite(v) for m in r0["losses"] for v in m.values())
    assert _digests_equal(r0["digests"], r1["digests"])
    assert r0["top1"] == r1["top1"]
    assert "model_0.pt" in r0["files"] and r1["files"] == []
