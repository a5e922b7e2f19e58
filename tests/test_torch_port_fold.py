"""FrozenBatchNorm folded into the ResNet convolutions on the CPU
(``models/resnet.py``, ``ops/conv_epilogue.py``): the folded stem and
blocks against today's unfolded composition (conv, x * scale + bias,
residual add, ReLU) in float32, forward and gradients; the fold cache
against in-place updates, ``load_state_dict``, swapped tensors and the
ensemble's ``functional_call``; the paths that do not fold (trainable
pairs, ``AdaptiveBatchNorm``, ``BasicBlock``); and the plain pass's
arithmetic and the kernel wrapper's refusals."""

import functools

import pytest
import torch
import torch.nn.functional as F
from torch.func import functional_call, stack_module_state
from torch.profiler import ProfilerActivity, profile

from torch_threads import one_thread  # noqa: F401 (autouse fixture)

from detectinblur_tpu_torch.models import resnet
from detectinblur_tpu_torch.models.batchnorm import AdaptiveBatchNorm
from detectinblur_tpu_torch.models.ensemble import select_specialist
from detectinblur_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    FrozenBatchNorm,
    ResNet,
    folded_weight,
)
from detectinblur_tpu_torch.ops.conv_epilogue import (
    conv_epilogue,
    conv_epilogue_kernel,
    conv_epilogue_plain,
)

# name -> (module factory, input channels, input side): the stem (the
# same in every arch) and the kinds of Bottleneck ResNet-50 has, at small
# widths.
MODULES = {
    "stem": (lambda norm: ResNet("resnet18", norm), 3, 32),
    "bottleneck": (lambda norm: Bottleneck(64, 16, 1, norm), 64, 12),
    "bottleneck_downsample": (lambda norm: Bottleneck(32, 16, 2, norm),
                              32, 12),
    # layer1's first block: a downsample that only widens, stride 1.
    "bottleneck_widen": (lambda norm: Bottleneck(16, 16, 1, norm), 16, 12),
    "bottleneck_odd_side": (lambda norm: Bottleneck(32, 16, 2, norm),
                            32, 13),
}


def _run(name, module, x):
    """The stem's pass (conv1, bn1, ReLU) or the whole block."""
    if name == "stem":
        if resnet._folds(module.bn1):
            return resnet._conv_relu(module.conv1, module.bn1, x)
        return F.relu(module.bn1(module.conv1(x)))
    return module(x)


def _make(name, seed=0, norm=FrozenBatchNorm):
    factory, cin, side = MODULES[name]
    gen = torch.Generator().manual_seed(seed)
    module = factory(norm)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / m.weight[0].numel()) ** 0.5)
            elif isinstance(m, (FrozenBatchNorm, AdaptiveBatchNorm)):
                m.scale.copy_(torch.rand(m.scale.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.rand(m.bias.shape, generator=gen) - 0.5)
    x = torch.randn(2, cin, side, side, generator=gen).contiguous(
        memory_format=torch.channels_last)
    return module, x


def _unfolded(monkeypatch, fn):
    """``fn()`` with every pair taking today's unfolded composition."""
    with monkeypatch.context() as mp:
        mp.setattr(resnet, "_folds", lambda norm: False)
        return fn()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _spans(fn):
    """Names of the ``user_annotation`` ranges ``fn()`` opens."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()
            if e.name in ("norm", "norm.fold")]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_folded_forward_and_gradients_match_unfolded(name, monkeypatch):
    """float32: the fold reassociates conv(x) * scale as conv(x, w *
    scale), one rounding per product; measured under 2e-6 relative."""
    module, x = _make(name)
    convs = [m for m in module.modules() if isinstance(m, torch.nn.Conv2d)]
    if name == "stem":
        convs = [module.conv1]

    def forward_backward():
        xg = x.clone().requires_grad_(True)
        out = _run(name, module, xg)
        (out * torch.linspace(-1, 1, out.numel()).view(out.shape)).sum(
        ).backward()
        grads = [xg.grad] + [c.weight.grad.clone() for c in convs]
        for c in convs:
            c.weight.grad = None
        return out.detach(), grads

    out, grads = forward_backward()
    ref, ref_grads = _unfolded(monkeypatch, forward_backward)
    assert out.shape == ref.shape
    assert _rel(out, ref) < 1e-5
    for g, r in zip(grads, ref_grads):
        assert _rel(g, r) < 1e-5
    with torch.no_grad():
        assert _rel(_run(name, module, x), ref) < 1e-5


@pytest.mark.parametrize("name", ["bottleneck_downsample", "bottleneck"])
def test_cache_follows_in_place_updates_and_load_state_dict(name,
                                                            monkeypatch):
    module, x = _make(name)
    opt = torch.optim.SGD(module.parameters(), lr=0.1)
    with torch.no_grad():
        before = _run(name, module, x)
    direction = torch.randn(before.shape,
                            generator=torch.Generator().manual_seed(2))
    (_run(name, module, x) * direction).sum().backward()
    opt.step()
    with torch.no_grad():
        after = _run(name, module, x)
        ref = _unfolded(monkeypatch, lambda: _run(name, module, x))
    assert _rel(after, before) > 1e-3
    assert _rel(after, ref) < 1e-5

    other, _ = _make(name, seed=1)
    module.load_state_dict(other.state_dict())
    with torch.no_grad():
        loaded = _run(name, module, x)
        ref = _run(name, other, x)
    assert _rel(loaded, after) > 1e-3
    assert _rel(loaded, ref) < 1e-6


def test_cache_hits_until_a_source_changes():
    module, _ = _make("bottleneck")
    conv, bn = module.conv2, module.bn2
    with torch.no_grad():
        w = folded_weight(conv, bn, torch.float32)
        assert folded_weight(conv, bn, torch.float32) is w
        assert folded_weight(conv, bn, torch.float64).dtype == torch.float64
        w = folded_weight(conv, bn, torch.float32)
        bn.scale.mul_(2)                        # in place: a new version
        assert torch.allclose(folded_weight(conv, bn, torch.float32), 2 * w)
        conv.weight.data = conv.weight.data.clone()   # same object, version
        assert folded_weight(conv, bn, torch.float32) is not w
        w = folded_weight(conv, bn, torch.float32)
        assert folded_weight(conv, bn, torch.float32) is w
        assert w.is_contiguous(memory_format=torch.channels_last)


def test_functional_call_over_specialists_matches_each_alone():
    """The ensemble's route: stacked specialists, one gathered by a
    device index and run through the template; alternating specialists
    swap the tensors under the cache."""
    models = [ResNet("resnet50") for _ in range(2)]
    for seed, m in enumerate(models):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
            for b in m.buffers():
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    params, buffers = stack_module_state(models)
    x = torch.randn(1, 3, 32, 32).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        alone = [m(x) for m in models]
        for i in (0, 1, 0, 1):
            index = torch.tensor(i)
            got = functional_call(models[0], (
                select_specialist(params, index),
                select_specialist(buffers, index)), (x,))
            for g, r in zip(got, alone[i]):
                assert _rel(g, r) < 1e-6


def test_folded_block_spans():
    """A Bottleneck with a downsample: 3 passes for 4 norms (the
    downsample's shift rides conv3's pass), 4 folds and the summed shift
    on the first call, none on the second."""
    module, x = _make("bottleneck_downsample")
    with torch.no_grad():
        first = _spans(lambda: module(x))
        second = _spans(lambda: module(x))
    assert first.count("norm") == 3 and first.count("norm.fold") == 5
    assert second == ["norm"] * 3
    # Under autograd every trainable weight folds on every call.
    grad = _spans(lambda: module(x))
    assert grad.count("norm.fold") == 4 and grad.count("norm") == 3


@pytest.mark.parametrize("norm", [
    functools.partial(FrozenBatchNorm, trainable=True),
    functools.partial(AdaptiveBatchNorm, mode="train"),
    functools.partial(AdaptiveBatchNorm, mode="eval"),
], ids=["trainable", "adaptive_train", "adaptive_eval"])
def test_unfolded_norms_keep_todays_path(norm, monkeypatch):
    """No fold, one ``norm`` span per norm, and the same numbers as the
    composition taken by hand."""
    module, x = _make("bottleneck_downsample", norm=norm)
    assert not resnet._folds(module.bn1)
    with torch.no_grad():
        spans = _spans(lambda: module(x))
        out = module(x)

        def by_hand():
            y = F.relu(module.bn1(module.conv1(x)))
            y = F.relu(module.bn2(module.conv2(y)))
            y = module.bn3(module.conv3(y))
            return F.relu(y + module.downsample_1(module.downsample_0(x)))
        ref = by_hand()
    assert spans == ["norm"] * 4
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("downsample", [False, True])
def test_basic_block_keeps_todays_path(downsample):
    """resnet18's block does not fold, even with buffer pairs: one
    ``norm`` span per norm, no ``norm.fold``."""
    gen = torch.Generator().manual_seed(0)
    block = BasicBlock(16, 32 if downsample else 16, 2 if downsample else 1)
    with torch.no_grad():
        for b in block.buffers():
            b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
        x = torch.randn(2, 16, 12, 12, generator=gen)
        spans = _spans(lambda: block(x))
        y = F.relu(block.bn1(block.conv1(x)))
        y = block.bn2(block.conv2(y))
        identity = (block.downsample_1(block.downsample_0(x)) if downsample
                    else x)
        ref = F.relu(y + identity)
        out = block(x)
    assert spans == ["norm"] * (3 if downsample else 2)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("channels", [8, 64])
def test_plain_pass_sums_in_float32_and_rounds_once(dtype, residual,
                                                    channels):
    gen = torch.Generator().manual_seed(0)
    y = torch.randn(2, channels, 5, 7, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last)
    r = (torch.randn(y.shape, generator=gen).to(dtype) if residual
         else None)
    shift = torch.randn(channels, generator=gen)
    out = conv_epilogue(y, shift, r)
    want = y.double() + shift.double().view(1, -1, 1, 1)
    if residual:
        want = want + r.double()
    want = want.clamp_min(0)
    assert out.dtype == dtype and out.shape == y.shape
    assert out.is_contiguous(memory_format=torch.channels_last)
    # One rounding of the float32 sum: within half an ulp of the float64
    # sum plus the float32 sum's own error.
    ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -23
    assert ((out.double() - want).abs()
            <= ulp * want.abs() + 1e-6).all()
    nan = y.clone()
    nan[0, 0, 0, 0] = float("nan")
    assert conv_epilogue_plain(nan, shift, r)[0, 0, 0, 0].isnan()


@pytest.mark.parametrize("case", ["channels", "dtype", "layout", "shift",
                                  "residual"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Checked before anything reaches the card (so on CPU tensors)."""
    y = torch.zeros(2, 16, 4, 4).contiguous(memory_format=torch.channels_last)
    shift, res = torch.zeros(16), None
    if case == "channels":
        y = torch.zeros(2, 12, 4, 4).contiguous(
            memory_format=torch.channels_last)
    elif case == "dtype":
        y = y.half()
    elif case == "layout":
        y = torch.zeros(2, 16, 4, 4)
    elif case == "shift":
        shift = torch.zeros(16, dtype=torch.bfloat16)
    else:
        res = torch.zeros(2, 16, 4, 5).contiguous(
            memory_format=torch.channels_last)
    with pytest.raises((TypeError, ValueError)):
        conv_epilogue_kernel(y, shift, res)
