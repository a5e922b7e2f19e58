"""The port's estimator-gated specialist ensemble held against the JAX
package on the CPU: four small detectors (full ResNet50-FPN widths at
64x64, as ``tests/remedy_helpers.py`` shrinks them) from four seeds, the
chosen specialist and its detections with the oracle, with a LEHE
estimator after deblur-first, and with a 16-class estimator; and the
gather of one specialist's weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remedy_helpers import BOX_KW, RPN_KW, match, psfs, resnet18_sd, weights
from synthetic_torch import synthetic_deepdeblur_state_dict
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

from detectinblur_tpu.models import ensemble as jax_ens
from detectinblur_tpu.models.classifier import (
    ResNetClassifier as JaxResNetClassifier,
)
from detectinblur_tpu.models.deblur import convert_deepdeblur_state_dict
from detectinblur_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from detectinblur_tpu.models.faster_rcnn import (
    FasterRCNNConfig as JaxFasterRCNNConfig,
)
from detectinblur_tpu.models.roi_heads import BoxHeadConfig as JaxBoxHeadConfig
from detectinblur_tpu.models.rpn import RPNConfig as JaxRPNConfig
from detectinblur_tpu.train import engine as jax_engine
from detectinblur_tpu.utils.torch_convert import (
    convert_fasterrcnn_state_dict,
    convert_resnet_classifier_state_dict,
)
from detectinblur_tpu_torch.models import ensemble
from detectinblur_tpu_torch.models.classifier import ResNetClassifier
from detectinblur_tpu_torch.models.deblur import MSResNet
from detectinblur_tpu_torch.models.faster_rcnn import (
    FasterRCNN,
    FasterRCNNConfig,
)
from detectinblur_tpu_torch.models.roi_heads import BoxHeadConfig
from detectinblur_tpu_torch.models.rpn import RPNConfig
from detectinblur_tpu_torch.train import engine
from detectinblur_tpu_torch.utils.convert import (
    classifier_from_torchvision,
    deepdeblur_from_torch,
    params_from_torchvision,
)

T = torch.from_numpy
BUCKET = (64, 64)
COMMON = dict(num_classes=5, min_size=BUCKET[0], max_size=BUCKET[1])


@pytest.fixture(scope="module")
def specialists():
    """(JAX model, stacked JAX params, the port's Specialists)."""
    sds = [weights(seed=s) for s in range(4)]
    jmodel = JaxFasterRCNN(JaxFasterRCNNConfig(
        rpn=JaxRPNConfig(**RPN_KW), box=JaxBoxHeadConfig(**BOX_KW), **COMMON))
    stacked = jax_ens.stack_params([convert_fasterrcnn_state_dict(sd)
                                    for sd in sds])
    models = []
    for sd in sds:
        m = FasterRCNN(FasterRCNNConfig(
            rpn=RPNConfig(**RPN_KW), box=BoxHeadConfig(**BOX_KW),
            precision="highest", **COMMON), device="cpu")
        m.load_state_dict(params_from_torchvision(sd, 5))
        models.append(m)
    return jmodel, stacked, ensemble.stack_specialists(models), models


def _estimators(n_classes):
    sd = resnet18_sd(n_classes, seed=3)
    params, stats = convert_resnet_classifier_state_dict(sd, include_fc=True)
    model = ResNetClassifier("resnet18", n_classes, "eval",
                             precision="highest", device="cpu")
    model.load_state_dict(classifier_from_torchvision(
        sd, num_classes=n_classes, include_fc=True))
    return (JaxResNetClassifier("resnet18", n_classes, "eval"),
            {"params": params, "batch_stats": stats}, model)


def _batch(seed):
    """One 56x60 image on the 64x64 canvas, blurred as type 2 at exposure
    index 4 (high), with three GT boxes."""
    rng = np.random.default_rng(seed)
    images = np.zeros((1, 64, 64, 3), np.float32)
    images[0, :56, :60] = rng.random((56, 60, 3))
    gt = np.array([[[4, 6, 30, 40], [20, 10, 50, 30], [0, 0, 12, 12]]],
                  np.float32)
    fields = dict(hw=np.array([[56, 60]], np.int32),
                  psfs=psfs(rng)[[4]], blurring=np.array([True]),
                  param_index=np.array([2], np.int32),
                  fraction_index=np.array([4], np.int32), gt_boxes=gt,
                  gt_labels=np.ones((1, 3), np.int64),
                  gt_valid=np.ones((1, 3), bool))
    ours = engine.BlurBatch(images=T(images), **{k: T(v) for k, v in
                                                 fields.items()})
    ref = jax_engine.BlurBatch(
        images=jnp.asarray(images), thetas=jnp.zeros(1), lam1s=jnp.ones(1),
        lam2s=jnp.ones(1), est_label=jnp.full(1, -1, jnp.int32),
        **{k: jnp.asarray(v) for k, v in fields.items()})
    return ours, ref


CASES = {
    # (estimator classes or None, deblur-first)
    "oracle": (None, False),
    "lehe-estimator-deblur": (4, True),
    "estimator-16": (16, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ensemble_predict_matches_jax(specialists, case):
    """The ensemble's eval step with the blur and the expanded-GT rewrite:
    the same specialist as JAX's, the same expanded GT (within 1e-4), and
    85% of JAX's valid detections matched (label, IoU > 0.95, score within
    2e-3; ``remedy_helpers.match``). The oracle picks specialist 3
    (type 2 at a high exposure). The detections are those of the chosen
    specialist run alone."""
    jmodel, stacked, ours_sp, models = specialists
    n_classes, deblur_first = CASES[case]
    ours_b, ref_b = _batch(seed=sorted(CASES).index(case))
    kw = dict(lehe=n_classes != 16, blur_eval=True, expand_target_boxes=True)
    deblurrer = deblur_vars = None
    if deblur_first:
        dsd = synthetic_deepdeblur_state_dict(3, 8, 2, seed=5)
        deblurrer = MSResNet.from_state_dict(deepdeblur_from_torch(dsd))
        deblur_vars = convert_deepdeblur_state_dict(dsd)
    jest = est_vars = est = None
    if n_classes is not None:
        jest, est_vars, est = _estimators(n_classes)
    dets, gt, index = ensemble.make_ensemble_predict(
        ours_sp.template, BUCKET, est, deblurrer=deblurrer, **kw)(
            ours_sp, ours_b)
    jdets, jgt, jindex = jax_ens.make_ensemble_predict(
        jmodel, BUCKET, jest, deblur_vars=deblur_vars, **kw)(
            stacked, est_vars, ref_b)
    assert index.dtype == torch.int64 and index.dim() == 0
    assert int(index) == int(jindex)
    if n_classes is None:
        assert int(index) == 3
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), atol=1e-4)
    assert not np.allclose(gt.numpy(), ours_b.gt_boxes.numpy())
    assert int(np.asarray(jdets.valid).sum()) > 3
    assert min(match(dets, jdets)) > 0.85
    prepared = engine.prepare_eval_batch(
        ours_b, blur_eval=True, expand_target_boxes=True, deblurrer=deblurrer)
    alone = models[int(index)].predict(prepared.images, prepared.hw, BUCKET)
    for a, b in zip(dets, alone):
        assert torch.equal(a, b)


def test_select_specialist_gathers_one(specialists):
    """Stacked parameters and buffers (the FrozenBatchNorm affines) carry
    the four specialists on the leading axis; the gather by a device
    index gives back each one's tensors exactly."""
    _, _, sp, models = specialists
    assert sp.template is models[0]
    assert sp.params["rpn_head.conv.weight"].shape[0] == 4
    assert "backbone.body.bn1.scale" in sp.buffers
    for i, m in enumerate(models):
        got = ensemble.select_specialist(sp.params, torch.tensor(i))
        got.update(ensemble.select_specialist(sp.buffers, torch.tensor(i)))
        for k, v in m.state_dict().items():
            assert torch.equal(got[k], v), (i, k)


def test_ensemble_refuses_batchnorm_specialists():
    """Stacking BatchNorm statistics is a feature the JAX ensemble lacks
    (it predicts with no ``bn_stats`` and fails): refused by name."""
    model = FasterRCNN(FasterRCNNConfig(bn_mode="mode_one", **COMMON),
                       device="meta")
    with pytest.raises(ValueError, match="mode_one"):
        ensemble.make_ensemble_predict(model, BUCKET)
