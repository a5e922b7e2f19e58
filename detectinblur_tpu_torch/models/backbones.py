"""Single-feature-map Faster R-CNN: ``--model mobile_net`` and
``--model resnet_50`` (port of ``detectinblur_tpu/models/backbones.py``).

The reference's ``create_model`` (versatile_backbone_models.py:13-119)
puts Faster R-CNN on the torso of a torchvision classifier, with ONE
feature map at stride 32: anchors of sizes 32..512 x ratios 0.5, 1, 2
(15 a cell) all on that map, and RoIAlign of every roi from it at scale
1/32. The torsos, named as the JAX param tree so that
``utils/convert.py`` maps it key for key:

  * ``MobileNetV2Features`` (JAX :81): torchvision ``mobilenet_v2.features``
    -> 1280 channels; every BatchNorm is a live ``AdaptiveBatchNorm``;
  * ``VGGFeatures`` (JAX :112), ``VGG_CFGS`` vgg11-19 -> 512 channels, no
    BatchNorm (not a CLI choice; ``SingleMapConfig`` accepts it);
  * the ResNet trunk of ``models/resnet.py`` -> C5 (2048 channels for
    resnet50): FrozenBatchNorm whose affines are parameters and train, as
    JAX's mask leaves everything outside ``backbone.body`` trainable, or
    ``AdaptiveBatchNorm`` with ``bn_mode``.

``SingleMapFasterRCNN`` (JAX :149) shares the FPN detector's stages
(``faster_rcnn.TwoStageDetector``): the engine, the CLIs and
``chip_smoke.py`` drive either one. Its RPN head maps the torso's
channels to 256 (JAX's ``RPNHead`` default width) and pools through
``roi_align_single_level_cuda``: the RoIAlign kernels on one level. Eval
uses the torso's BatchNorms in ``cfg.bn_mode`` (running statistics when
None); ``loss`` runs them on batch statistics (``train``) and writes the
running-statistics update, as JAX's train torso (:159-183). The Squint
warp's arguments are accepted and ignored, as in JAX (:237, 272): the
reference comments the warp out for these models.

Precision as the FPN detector: ``highest`` float32 with TF32 off;
``default`` convolutions in bfloat16 (BatchNorm outputs float32, the next
convolution casts back) and the torso's output cast to bfloat16 for the
RPN, the pooling and the box head. JAX pools MobileNetV2's float32 map
there and casts in the head; the two differ by bfloat16 rounding.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from detectinblur_tpu_torch.models.batchnorm import (
    AdaptiveBatchNorm,
    bn_mode,
    training_mode,
)
from detectinblur_tpu_torch.models.faster_rcnn import (
    TwoStageDetector,
    reset_box_heads,
)
from detectinblur_tpu_torch.models.resnet import (
    Conv2d,
    FrozenBatchNorm,
    ResNet,
    reset_trunk,
    set_compute_dtype,
)
from detectinblur_tpu_torch.models.roi_heads import (
    BoxHeadConfig,
    FastRCNNPredictor,
    TwoMLPHead,
)
from detectinblur_tpu_torch.models.rpn import RPNConfig, RPNHead, level_anchors
from detectinblur_tpu_torch.ops.roi_align_cuda import roi_align_single_level_cuda
from detectinblur_tpu_torch.utils.device import (
    DEFAULT_PRECISION,
    act_dtype,
    check_precision,
    resolve_device,
    set_fp32_math,
)

SINGLE_MAP_ANCHOR_SIZES = ((32.0, 64.0, 128.0, 256.0, 512.0),)
SINGLE_MAP_ASPECT_RATIOS = ((0.5, 1.0, 2.0),)
# (expansion t, out channels c, blocks n, first stride s): MobileNetV2.
MOBILENET_V2_CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                    (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                    (6, 320, 1, 1))


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(F.relu(x), max=6.0)


def _add_conv_bn(module: nn.Module, name: str, cin: int, cout: int, k: int,
                 stride: int, norm, groups: int = 1) -> None:
    """``{name}_conv`` (no bias) and ``{name}_bn`` on ``module``, the JAX
    ``_conv_bn6`` pair."""
    setattr(module, f"{name}_conv",
            Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                   groups=groups, bias=False))
    setattr(module, f"{name}_bn", norm(cout))


def _conv_bn6(module: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
    """conv -> BatchNorm -> ReLU6 = min(relu(x), 6)."""
    conv, bn = getattr(module, f"{name}_conv"), getattr(module, f"{name}_bn")
    return _relu6(bn(conv(x)))


class InvertedResidual(nn.Module):
    """MobileNetV2 block: 1x1 expand (when t != 1), 3x3 depthwise
    (``groups=hidden``), 1x1 linear projection, residual on a same-shape
    stride-1 block."""

    def __init__(self, cin: int, out_ch: int, stride: int, expand: int,
                 norm):
        super().__init__()
        hidden = cin * expand
        self.expand = expand != 1
        if self.expand:
            _add_conv_bn(self, "expand", cin, hidden, 1, 1, norm)
        _add_conv_bn(self, "depthwise", hidden, hidden, 3, stride, norm,
                     groups=hidden)
        _add_conv_bn(self, "project", hidden, out_ch, 1, 1, norm)
        self.residual = stride == 1 and cin == out_ch

    def forward(self, x):
        y = _conv_bn6(self, "expand", x) if self.expand else x
        y = _conv_bn6(self, "depthwise", y)
        y = self.project_bn(self.project_conv(y))
        return x + y if self.residual else y


class MobileNetV2Features(nn.Module):
    """torchvision ``mobilenet_v2.features`` over NCHW: stem 32, 17
    inverted residuals (``block1`` .. ``block17``), head 1280 ->
    [B, 1280, H/32, W/32]."""

    out_channels = 1280

    def __init__(self, bn_mode: str = "eval"):
        super().__init__()
        norm = functools.partial(AdaptiveBatchNorm, mode=bn_mode)
        _add_conv_bn(self, "stem", 3, 32, 3, 2, norm)
        cin, i = 32, 1
        for t, c, n, s in MOBILENET_V2_CFG:
            for b in range(n):
                self.add_module(f"block{i}", InvertedResidual(
                    cin, c, s if b == 0 else 1, t, norm))
                cin, i = c, i + 1
        self.n_blocks = i - 1
        _add_conv_bn(self, "head", cin, self.out_channels, 1, 1, norm)

    def forward(self, x):
        x = _conv_bn6(self, "stem", x)
        for i in range(1, self.n_blocks + 1):
            x = getattr(self, f"block{i}")(x)
        return _conv_bn6(self, "head", x)


VGG_CFGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
              512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGGFeatures(nn.Module):
    """torchvision VGG ``features`` over NCHW: 3x3 convs with bias
    (``conv0`` ...) and ReLU, 2x2 max pools -> [B, 512, H/32, W/32]."""

    out_channels = 512

    def __init__(self, arch: str = "vgg16"):
        super().__init__()
        self.cfg = VGG_CFGS[arch]
        cin, i = 3, 0
        for v in self.cfg:
            if v != "M":
                self.add_module(f"conv{i}", Conv2d(cin, v, 3, padding=1))
                cin, i = v, i + 1

    def forward(self, x):
        i = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, stride=2)
            else:
                x = F.relu(getattr(self, f"conv{i}")(x))
                i += 1
        return x


class SingleMapConfig(NamedTuple):
    backbone: str = "mobile_net"        # mobile_net | vggNN | resnetNN
    num_classes: int = 91
    # create_model defaults (versatile_backbone_models.py:13): min 300 /
    # max 500, not the FPN detector's 800/1333.
    min_size: int = 300
    max_size: int = 500
    rpn: RPNConfig = RPNConfig()
    box: BoxHeadConfig = BoxHeadConfig()
    stride: int = 32
    # Eval-time BatchNorm mode: None = running statistics (mobile_net) or
    # FrozenBatchNorm (resnet; vgg has none); else an AdaptiveBatchNorm
    # mode, which a resnet torso then takes too. Training always runs the
    # BatchNorms on batch statistics.
    bn_mode: Optional[str] = None
    precision: str = DEFAULT_PRECISION


class SingleMapFasterRCNN(TwoStageDetector):
    """Faster R-CNN over one torso map, built on ``device`` (CUDA unless
    the caller asks for another) and initialised from a generator seeded
    with ``seed`` as the JAX initialisers do: kaiming-normal fan_out
    convolutions with zero biases, identity BatchNorms, N(0, 0.01) RPN
    head, torch Linear defaults for the box head and predictor."""

    def __init__(self, config: SingleMapConfig = SingleMapConfig(),
                 device=None, seed: int = 0):
        super().__init__()
        check_precision(config.precision)
        self.cfg = config
        self.act_dtype = act_dtype(config.precision)
        device = resolve_device(device)
        name = config.backbone
        with torch.device("meta" if device.type == "meta" else "cpu"):
            if name == "mobile_net":
                self.backbone = MobileNetV2Features(config.bn_mode or "eval")
                channels = MobileNetV2Features.out_channels
            elif name.startswith("vgg"):
                self.backbone = VGGFeatures(name)
                channels = VGGFeatures.out_channels
            elif name.startswith("res"):
                norm = (functools.partial(FrozenBatchNorm, trainable=True)
                        if config.bn_mode is None else functools.partial(
                            AdaptiveBatchNorm, mode=config.bn_mode))
                self.backbone = ResNet(name, norm)
                channels = self.backbone.out_channels[-1]
            else:
                raise ValueError(f"unknown single-map backbone {name!r}")
            self.rpn_head = RPNHead(channels, num_anchors=len(
                SINGLE_MAP_ANCHOR_SIZES[0]) * len(SINGLE_MAP_ASPECT_RATIOS[0]))
            self.box_head = TwoMLPHead(channels)
            self.box_predictor = FastRCNNPredictor(
                num_classes=config.num_classes)
        set_compute_dtype(self.backbone, self.act_dtype)
        if device.type != "meta":
            self.reset_parameters(torch.Generator().manual_seed(seed))
        if device.type == "cuda":
            set_fp32_math()
        self.to(device=device, memory_format=torch.channels_last)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_trunk(self.backbone, generator, skip="\0")
        for m in self.backbone.modules():
            if isinstance(m, nn.Conv2d) and m.bias is not None:
                m.bias.zero_()
        self.rpn_head.reset_parameters(generator)
        reset_box_heads(self, generator)

    @property
    def has_bn(self) -> bool:
        """The torso has BatchNorms with running statistics."""
        return any(isinstance(m, AdaptiveBatchNorm)
                   for m in self.backbone.modules())

    def _training_torso(self):
        """The torso in training mode with every BatchNorm on batch
        statistics (JAX's ``_train_torso``), for ``loss``."""
        stack = contextlib.ExitStack()
        stack.enter_context(training_mode(self.backbone))
        if self.has_bn:
            stack.enter_context(bn_mode(self.backbone, "train"))
        return stack

    # ------------------------------------------------------------- stages
    def features(self, batched: torch.Tensor, thetas=None, lam1s=None,
                 lam2s=None):
        """-> (map,): the torso's map NHWC [B, H/32, W/32, C] in the
        activation dtype. The warp's arguments are ignored, as in JAX."""
        del thetas, lam1s, lam2s
        x = batched.to(self.act_dtype).permute(0, 3, 1, 2)
        out = self.backbone(x)
        if isinstance(out, tuple):
            out = out[-1]                     # resnet trunk: C5
        return (out.to(self.act_dtype).permute(0, 2, 3, 1),)

    def level_anchors(self, feats):
        """The one level's 15 anchors a cell at the torso's stride,
        cached by the map's shape."""
        key = tuple(feats[0].shape[1:3])
        if key not in self._anchors:
            self._anchors[key] = level_anchors(
                feats, self.cfg.stride, SINGLE_MAP_ANCHOR_SIZES,
                SINGLE_MAP_ASPECT_RATIOS)
        return self._anchors[key]

    def pool(self, feats, proposals: torch.Tensor, valid: torch.Tensor):
        """RoIAlign of the proposals on the one map at 1/stride ->
        [B, P, 7, 7, C]; invalid slots zeroed first, as the FPN
        detector's (their outputs are masked out later)."""
        rois = torch.where(valid[..., None], proposals,
                           torch.zeros_like(proposals))
        return roi_align_single_level_cuda(feats[0].contiguous(), rois,
                                           1.0 / self.cfg.stride)
