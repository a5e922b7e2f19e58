"""ResNet trunks and the ResNet50-FPN backbone in torch (port of
``detectinblur_tpu/models/resnet.py``).

Module names mirror the JAX param tree (``body.layer1_0.conv1``,
``fpn.inner_0`` ...) so ``utils/convert.py`` maps it key for key.
Convolutions run channels-last: the NHWC input permuted to NCHW is already
a channels-last tensor, and so are all activations after it. The public
boundary stays NHWC, as in the JAX package.

FrozenBatchNorm is the affine (scale, bias) pair of the JAX version; a
fresh module is the identity. The FPN detector keeps the pair as buffers
(its freeze mask never trains them); ``trainable=True`` makes them
parameters, as in JAX, for the single-map ResNet torso, whose affines
train (``models/backbones.py``). With ``bn_mode`` set, the backbone's
BatchNorms are ``models/batchnorm.AdaptiveBatchNorm`` in that mode
instead (the JAX ``norm`` argument, :135,164,197,260).

In the stem and ``Bottleneck`` (ResNet-50's blocks), a FrozenBatchNorm
whose pair are buffers folds into the convolution before it
(``_folds``): the convolution runs with ``weight * scale``
(``folded_weight``, cached while nothing needs its gradient) and one
pass (``ops/conv_epilogue.py``, span ``norm``) adds the shift and, where
the block has them, the residual and the ReLU. A block's last pass also
carries its downsample's shift, so the downsample has no pass of its
own: a ResNet-50 forward makes 49 passes for its 53 norms. Every
recomputed fold opens span ``norm.fold``. The trainable pairs,
``AdaptiveBatchNorm`` and ``BasicBlock`` (resnet18, whose trunks in the
port have one of the two) run the unfolded composition.

The trunk is the JAX arch table's ``resnet50`` (``Bottleneck``; the
FPN's and ``--model resnet_50``'s) or ``resnet18`` (``BasicBlock``, the
blur estimator's, :160,181).

Parameters stay float32 in every precision; ``Conv2d`` and ``Linear`` cast
their weights to the dtype they compute in on each call (a folded
convolution casts its folded weight once), as the JAX modules'
``dtype=ACT_DTYPE`` does, so throughput mode computes in bfloat16
while SGD updates float32 weights (a bfloat16 weight would round a
warmup-sized update away). A ``Conv2d`` whose ``compute_dtype`` is set
casts its input to it first, as each JAX ``nn.Conv`` does: under
``AdaptiveBatchNorm`` the activations between convolutions are float32.

Initialisation follows the JAX initialisers (resnet.py:59-82):
kaiming-normal fan_out for the trunk convs, kaiming-uniform a=1 for the
FPN convs with zero bias.
"""

from __future__ import annotations

import functools
import weakref
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from detectinblur_tpu_torch.models.batchnorm import AdaptiveBatchNorm
from detectinblur_tpu_torch.ops.conv_epilogue import conv_epilogue
from detectinblur_tpu_torch.utils.graphs import hold
from detectinblur_tpu_torch.utils.profiling import span

_WIDTHS = (64, 128, 256, 512)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``, or in its input's
    dtype while that is None (float32 parameters)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype (float32 parameters)."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class FrozenBatchNorm(nn.Module):
    """Affine-only BatchNorm over NCHW: y = x * scale + bias, the pair
    buffers, or parameters with ``trainable``."""

    def __init__(self, features: int, trainable: bool = False):
        super().__init__()
        self.trainable = trainable
        if trainable:
            self.scale = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_buffer("scale", torch.ones(features))
            self.register_buffer("bias", torch.zeros(features))

    def forward(self, x):
        with span("norm"):
            return (x * self.scale.to(x.dtype)[:, None, None]
                    + self.bias.to(x.dtype)[:, None, None])


def _folds(norm: nn.Module) -> bool:
    """Whether ``norm`` folds into the convolution before it: a
    FrozenBatchNorm whose pair are buffers."""
    return isinstance(norm, FrozenBatchNorm) and not norm.trainable


# owner module -> (its sources, held weakly; their keys; the derived tensor)
_DERIVED: "weakref.WeakKeyDictionary[nn.Module, tuple]" = (
    weakref.WeakKeyDictionary())


def _cached(owner: nn.Module, sources: Tuple[torch.Tensor, ...], tag,
            make: Callable[..., torch.Tensor]) -> torch.Tensor:
    """``make(*sources)``, kept for ``owner`` until a source is another
    tensor object or changes. A source is known by the object itself
    (held weakly) and its ``_version``, which every in-place write bumps
    (an optimizer step, ``load_state_dict``); its data pointer besides
    catches what keeps both, ``module.to()`` and ``.data =``. ``tag``
    (the target dtype) is part of the key, and so is inference mode: a
    tensor made under it may not be saved for a backward outside it. A
    miss opens ``norm.fold``. A CUDA graph capture reading the tensor
    keeps it (``utils/graphs.py::hold``): a later miss replaces it here,
    not in the graphs."""
    key = (tag, torch.is_inference_mode_enabled()) + tuple(
        (t._version, t.data_ptr()) for t in sources)
    entry = _DERIVED.get(owner)
    if (entry is not None and entry[1] == key
            and all(ref() is t for ref, t in zip(entry[0], sources))):
        return hold(entry[2])
    with span("norm.fold"):
        value = make(*sources)
    _DERIVED[owner] = (tuple(weakref.ref(t) for t in sources), key, value)
    return hold(value)


def _fold(weight: torch.Tensor, scale: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """``weight * scale`` per output channel in the parameters' float32,
    cast once to ``dtype``, channels-last (the layout cuDNN takes it in
    here)."""
    return (weight * scale.view(-1, 1, 1, 1)).to(
        dtype, memory_format=torch.channels_last)


def folded_weight(conv: Conv2d, norm: FrozenBatchNorm,
                  dtype: torch.dtype) -> torch.Tensor:
    """``conv``'s weight with ``norm``'s scale folded in, in ``dtype``:
    folded under autograd on every call where a gradient is needed, else
    cached (predict, the eval step, the frozen stages of a train step)."""
    w, scale = conv.weight, norm.scale
    if torch.is_grad_enabled() and (w.requires_grad or scale.requires_grad):
        with span("norm.fold"):
            return _fold(w, scale, dtype)
    return _cached(conv, (w, scale), dtype,
                   lambda w, s: _fold(w, s, dtype))


def folded_conv(conv: Conv2d, norm: FrozenBatchNorm,
                x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` with ``norm``'s scale folded into the weight; the shift
    is left to the pass."""
    if conv.compute_dtype is not None:
        x = x.to(conv.compute_dtype)
    return conv._conv_forward(x, folded_weight(conv, norm, x.dtype), None)


def _conv_relu(conv: Conv2d, norm: FrozenBatchNorm, x: torch.Tensor,
               residual: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(norm(conv(x)) [+ residual]): the folded convolution, then one
    pass adding ``shift`` (``norm``'s when None)."""
    y = folded_conv(conv, norm, x)
    with span("norm"):
        return conv_epilogue(y, norm.bias if shift is None else shift,
                             residual)


def _block_out(block: nn.Module, conv: Conv2d, norm: FrozenBatchNorm,
               y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A folded block's last pass, relu(norm(conv(y)) + identity): the
    identity is ``x``, or the downsample's folded convolution of ``x``,
    whose shift rides the pass (the two shifts summed once and cached)."""
    if block.downsample_0 is None:
        return _conv_relu(conv, norm, y, residual=x)
    down = block.downsample_1
    identity = folded_conv(block.downsample_0, down, x)
    shift = _cached(down, (norm.bias, down.bias), None, torch.add)
    return _conv_relu(conv, norm, y, identity, shift)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                  bias=False)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1,
                 norm: Callable[[int], nn.Module] = FrozenBatchNorm):
        super().__init__()
        out_ch = width * self.expansion
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = norm(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = norm(width)
        self.conv3 = _conv(width, out_ch, 1)
        self.bn3 = norm(out_ch)
        self.downsample_0: Optional[Conv2d] = None
        if cin != out_ch or stride != 1:
            self.downsample_0 = _conv(cin, out_ch, 1, stride)
            self.downsample_1 = norm(out_ch)

    def forward(self, x):
        if _folds(self.bn1):
            y = _conv_relu(self.conv1, self.bn1, x)
            y = _conv_relu(self.conv2, self.bn2, y)
            return _block_out(self, self.conv3, self.bn3, y, x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x
        if self.downsample_0 is not None:
            identity = self.downsample_1(self.downsample_0(x))
        return F.relu(y + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1,
                 norm: Callable[[int], nn.Module] = FrozenBatchNorm):
        super().__init__()
        self.conv1 = _conv(cin, width, 3, stride)
        self.bn1 = norm(width)
        self.conv2 = _conv(width, width, 3)
        self.bn2 = norm(width)
        self.downsample_0: Optional[Conv2d] = None
        if cin != width or stride != 1:
            self.downsample_0 = _conv(cin, width, 1, stride)
            self.downsample_1 = norm(width)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x
        if self.downsample_0 is not None:
            identity = self.downsample_1(self.downsample_0(x))
        return F.relu(y + identity)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Every ``Conv2d`` of ``module`` computes in ``dtype`` (JAX's
    ``ACT_DTYPE``), whatever dtype its input arrives in."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = dtype


def reset_trunk(module: nn.Module, generator: torch.Generator,
                skip: str = "fpn.") -> None:
    """The JAX initialisers of a ResNet trunk: kaiming-normal fan_out
    convolutions (except those under ``skip``), identity BatchNorms with
    fresh running statistics."""
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, nn.Conv2d) and not name.startswith(skip):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu",
                                        generator=generator)
            elif isinstance(m, (FrozenBatchNorm, AdaptiveBatchNorm)):
                m.scale.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, AdaptiveBatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
                    m.num_batches_tracked.zero_()


# arch -> (block, blocks per stage), the JAX RESNET_SPECS rows ported.
RESNET_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}


class ResNet(nn.Module):
    """torchvision-layout ResNet trunk (``arch`` a ``RESNET_SPECS`` key)
    returning (C2, C3, C4, C5), NCHW channels-last."""

    def __init__(self, arch: str = "resnet50",
                 norm: Callable[[int], nn.Module] = FrozenBatchNorm):
        super().__init__()
        block, layers = RESNET_SPECS[arch]
        self.layers = layers
        self.out_channels = tuple(w * block.expansion for w in _WIDTHS)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = norm(64)
        cin = 64
        for i, (n_blocks, width) in enumerate(zip(self.layers, _WIDTHS)):
            for b in range(n_blocks):
                stride = 2 if (b == 0 and i > 0) else 1
                self.add_module(f"layer{i + 1}_{b}",
                                block(cin, width, stride, norm))
                cin = width * block.expansion

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        if _folds(self.bn1):
            x = _conv_relu(self.conv1, self.bn1, x)
        else:
            x = F.relu(self.bn1(self.conv1(x)))
        # torch maxpool pads with -inf, as the JAX version does explicitly.
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for i, n_blocks in enumerate(self.layers):
            for b in range(n_blocks):
                x = getattr(self, f"layer{i + 1}_{b}")(x)
            outs.append(x)
        return tuple(outs)


class FPN(nn.Module):
    """Feature Pyramid Network with LastLevelMaxPool (P2..P5 + P6)."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"inner_{i}", Conv2d(c, out_channels, 1))
            self.add_module(f"layer_{i}",
                            Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"inner_{i}")(f)
                    for i, f in enumerate(feats)]
        ps = [laterals[-1]]
        for i in range(len(laterals) - 2, -1, -1):
            up = F.interpolate(ps[0], size=laterals[i].shape[-2:],
                               mode="nearest")
            ps.insert(0, laterals[i] + up)
        outs = [getattr(self, f"layer_{i}")(p) for i, p in enumerate(ps)]
        # LastLevelMaxPool: 1x1 window, stride 2 == subsample by 2.
        return outs + [outs[-1][:, :, ::2, ::2]]


class ResNetFPN(nn.Module):
    """images NHWC [B, H, W, 3] -> (P2, P3, P4, P5, P6), each NHWC in
    ``act_dtype``. ``bn_mode`` None keeps FrozenBatchNorm; a mode of
    ``AdaptiveBatchNorm`` makes every BatchNorm of the body one."""

    def __init__(self, out_channels: int = 256,
                 act_dtype: torch.dtype = torch.float32,
                 bn_mode: Optional[str] = None):
        super().__init__()
        self.act_dtype = act_dtype
        norm = (FrozenBatchNorm if bn_mode is None
                else functools.partial(AdaptiveBatchNorm, mode=bn_mode))
        self.body = ResNet(norm=norm)
        self.fpn = FPN(out_channels=out_channels)
        set_compute_dtype(self, act_dtype)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = images.to(self.act_dtype).permute(0, 3, 1, 2)  # channels-last NCHW
        feats = self.fpn(self.body(x))
        return tuple(f.permute(0, 2, 3, 1) for f in feats)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # The body's draws come first, then the FPN's, in module order.
        reset_trunk(self, generator, skip="fpn.")
        for m in self.fpn.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_uniform_(m.weight, a=1, generator=generator)
                nn.init.zeros_(m.bias)
