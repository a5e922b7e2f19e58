"""Readings behind the MobileNetV2 gradient limits of
``test_torch_port_backbones.py::test_loss_gradients_match_jax``.

For each size it runs the single-map ``mobile_net`` loss of the test's
``_pair`` (JAX's draws injected, proposals at the anchors) in JAX and in
the port on the CPU, ``highest`` precision, and prints each tensor's
gradient error against JAX over its largest magnitude (floored at 1e-5
of the model's largest gradient): the largest, the median, the heads'
largest, the L2 error of the whole gradient, and the port's own spread
when the images move by 1e-8 and by 1e-6.

    JAX_PLATFORMS=cpu python tests/gradient_conditioning.py
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import test_torch_port_backbones as tb  # noqa: E402
from remedy_helpers import jax_loss_draws, np_tree  # noqa: E402

from detectinblur_tpu_torch.utils.convert import params_from_jax  # noqa: E402

SIZES = ((2, (96, 128)), (4, (192, 256)), (2, (320, 416)))
G = 3


def readings(B, bucket):
    tb.BUCKET = bucket
    tb.HW = np.array([list(bucket)] + [[int(bucket[0] * 0.85),
                                         int(bucket[1] * 0.8)]] * (B - 1),
                     np.int32)
    jmodel, params, stats, model = tb._pair("mobile_net", zero_rpn=True)
    rng = np.random.default_rng(8)
    images = rng.random((B, *bucket, 3), np.float32)
    gt = np.zeros((B, G, 4), np.float32)
    gt[..., :2] = rng.uniform(0, bucket[0] * 0.5, (B, G, 2))
    gt[..., 2:] = gt[..., :2] + rng.uniform(bucket[0] * 0.2,
                                            bucket[0] * 0.6, (B, G, 2))
    labels = rng.integers(1, tb.N_CLASSES, (B, G)).astype(np.int32)
    valid = np.ones((B, G), bool)
    key = jax.random.key(9)

    def total(p):
        losses, new = jmodel.loss(p, key, jnp.asarray(images),
                                  jnp.asarray(tb.HW), gt, labels, valid,
                                  bucket=bucket, bn_stats=stats)
        return sum(losses.values()), new

    jgrads = jax.jit(jax.grad(total, has_aux=True))(params)[0]
    A = 15 * (bucket[0] // 32) * (bucket[1] // 32)
    draws = jax_loss_draws(key, B, A, tb.RPN_KW["post_nms_top_n_train"] + G)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def grads(imgs):
        model.load_state_dict(start)
        model.zero_grad()
        losses = model.loss(torch.from_numpy(imgs), tb.HW,
                            torch.from_numpy(gt), torch.from_numpy(labels),
                            torch.from_numpy(valid), bucket, draws=draws)
        sum(losses.values()).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    ours = grads(images)
    ref = params_from_jax(np_tree(jgrads), tb.N_CLASSES,
                          tb._zero_stats(model), backbone="mobile_net")
    top = max(ref[n].abs().max().item() for n in ours)

    def errs(got, want):
        return {n: (g - want[n]).abs().max().item()
                / max(ref[n].abs().max().item(), 1e-5 * top)
                for n, g in got.items()}

    err = errs(ours, ref)
    l2 = (sum(float(((ours[n] - ref[n]).double() ** 2).sum()) for n in ours)
          / sum(float((ref[n].double() ** 2).sum()) for n in ours)) ** 0.5
    worst = max(err, key=err.get)
    print(f"{B} x {bucket[0]}x{bucket[1]}: against JAX, largest {err[worst]:.3g}"
          f" ({worst}), median {np.median(list(err.values())):.3g}, heads' "
          f"largest {max(e for n, e in err.items() if not n.startswith('backbone.')):.3g}"
          f", L2 {l2:.3g}")
    noise = np.random.default_rng(0).standard_normal(images.shape).astype(
        np.float32)
    for eps in (1e-8, 1e-6):
        spread = errs(grads(images + np.float32(eps) * noise), ours)
        print(f"    the port's own under a {eps:g} nudge: largest "
              f"{max(spread.values()):.3g}, median "
              f"{np.median(list(spread.values())):.3g}")


if __name__ == "__main__":
    for B, bucket in SIZES:
        readings(B, bucket)
