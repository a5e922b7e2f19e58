"""The plain reference detectors: Faster R-CNN on ResNet50-FPN and on the
one stride-32 map of MobileNetV2, their ``predict`` and their training
losses, in float32 torch.

A frozen copy of the port's ``models/resnet.py``, ``models/backbones.py``
(MobileNetV2), ``models/batchnorm.py`` (train and eval modes),
``models/rpn.py``, ``models/roi_heads.py`` and ``models/faster_rcnn.py``
without its kernels: NMS and RoIAlign come from ``reference/ops.py``.
Submodules and parameters carry the port's names, so that one state dict
loads into either. Widths come from the configuration file.

``set_quant`` puts the model in the control's precision, float8
training's: every convolution's and linear layer's input and weight
rounded to float8 e4m3 (one scale a tensor, the largest magnitude to 448)
with the product taken in the model's dtype, the cotangent of its output
rounded to float8 e5m2 (one scale a tensor) in the backward, and every
normalization's, block's and backbone's output stored in e4m3.
"""

from __future__ import annotations

import importlib
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops

FP8_MAX = 448.0        # float8 e4m3's largest magnitude
FP8_GRAD_MAX = 57344.0  # float8 e5m2's


class _Fp8Grad(torch.autograd.Function):
    """Identity forward; the backward rounds the cotangent to float8 e5m2
    under one scale (amax -> 57344), as float8 training keeps gradients."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        scale = g.abs().amax().clamp(min=1e-30) / FP8_GRAD_MAX
        return (g / scale).to(torch.float8_e5m2).to(g.dtype) * scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (amax -> 448); the
    gradient passes straight through, so that the backward's products
    take the rounded operands and float32 cotangents."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


class Conv2d(nn.Conv2d):
    quant = False

    def forward(self, x):
        x = x.to(self.weight.dtype)
        w = self.weight
        if self.quant:
            return _Fp8Grad.apply(self._conv_forward(fp8(x), fp8(w),
                                                     self.bias))
        return self._conv_forward(x, w, self.bias)


class Linear(nn.Linear):
    quant = False

    def forward(self, x):
        x = x.to(self.weight.dtype)
        w = self.weight
        if self.quant:
            return _Fp8Grad.apply(F.linear(fp8(x), fp8(w), self.bias))
        return F.linear(x, w, self.bias)


def _fp8_outputs(module, inputs, output):
    """Forward hook: the module's output rounded to float8 e4m3, so that
    every activation between layers is stored in the control's
    precision."""
    if isinstance(output, tuple):
        return tuple(fp8(o) for o in output)
    return fp8(output)


def set_quant(module: nn.Module, on: bool) -> None:
    """The control's precision on (float8 products, cotangents, and every
    normalization's and block's output) or off."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.quant = on
        if isinstance(m, STORED):
            for h in m.__dict__.pop("_fp8_hooks", ()):
                h.remove()
            if on:
                m._fp8_hooks = [m.register_forward_hook(_fp8_outputs)]


class FrozenBatchNorm(nn.Module):
    """y = x * scale + bias, the pair buffers (never trained)."""

    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))

    def forward(self, x):
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class BatchNorm(nn.Module):
    """BatchNorm whose affine trains: on the batch's statistics over N, H
    and W (biased variance E[x^2] - m^2) in training, on the running ones
    otherwise. The running statistics are not updated here."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros(()))

    def forward(self, x):
        if self.training:
            m = x.mean(dim=(0, 2, 3))
            v = x.square().mean(dim=(0, 2, 3)) - m.square()
        else:
            m, v = self.running_mean, self.running_var
        inv = torch.rsqrt(v + self.eps)
        shape = (1, -1, 1, 1)
        return ((x - m.view(shape)) * inv.view(shape) * self.scale.view(shape)
                + self.bias.view(shape))


def _conv(cin, cout, k, stride=1, groups=1, bias=False):
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups,
                  bias=bias)


class Bottleneck(nn.Module):
    def __init__(self, cin, width, stride, expansion):
        super().__init__()
        out = width * expansion
        self.conv1, self.bn1 = _conv(cin, width, 1), FrozenBatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3, self.bn3 = _conv(width, out, 1), FrozenBatchNorm(out)
        self.downsample_0 = None
        if cin != out or stride != 1:
            self.downsample_0 = _conv(cin, out, 1, stride)
            self.downsample_1 = FrozenBatchNorm(out)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample_0 is not None:
            x = self.downsample_1(self.downsample_0(x))
        return F.relu(y + x)


class ResNetFPN(nn.Module):
    """ResNet trunk (Bottleneck, FrozenBatchNorm) and FPN with
    LastLevelMaxPool: NHWC images -> (P2 .. P6) NHWC."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.body = nn.Module()
        self.blocks = cfg["blocks"]
        widths, expansion = cfg["widths"], cfg["expansion"]
        self.body.conv1 = Conv2d(3, cfg["stem"], 7, stride=2, padding=3,
                                 bias=False)
        self.body.bn1 = FrozenBatchNorm(cfg["stem"])
        cin = cfg["stem"]
        for i, (n, w) in enumerate(zip(self.blocks, widths)):
            for b in range(n):
                self.body.add_module(f"layer{i + 1}_{b}", Bottleneck(
                    cin, w, 2 if b == 0 and i > 0 else 1, expansion))
                cin = w * expansion
        self.fpn = nn.Module()
        c = cfg["fpn_channels"]
        for i, w in enumerate(widths):
            self.fpn.add_module(f"inner_{i}", _conv(w * expansion, c, 1,
                                                    bias=True))
            self.fpn.add_module(f"layer_{i}", _conv(c, c, 3, bias=True))

    def forward(self, images):
        b = self.body
        x = F.relu(b.bn1(b.conv1(images.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        cs = []
        for i, n in enumerate(self.blocks):
            for j in range(n):
                x = getattr(b, f"layer{i + 1}_{j}")(x)
            cs.append(x)
        lat = [getattr(self.fpn, f"inner_{i}")(c) for i, c in enumerate(cs)]
        ps = [lat[-1]]
        for i in range(len(lat) - 2, -1, -1):
            ps.insert(0, lat[i] + F.interpolate(ps[0], size=lat[i].shape[-2:],
                                                mode="nearest"))
        outs = [getattr(self.fpn, f"layer_{i}")(p) for i, p in enumerate(ps)]
        outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(o.permute(0, 2, 3, 1) for o in outs)


class InvertedResidual(nn.Module):
    def __init__(self, cin, cout, stride, expand):
        super().__init__()
        hidden = cin * expand
        self.expand = expand != 1
        if self.expand:
            self.expand_conv = _conv(cin, hidden, 1)
            self.expand_bn = BatchNorm(hidden)
        self.depthwise_conv = _conv(hidden, hidden, 3, stride, groups=hidden)
        self.depthwise_bn = BatchNorm(hidden)
        self.project_conv = _conv(hidden, cout, 1)
        self.project_bn = BatchNorm(cout)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = x
        if self.expand:
            y = F.relu6(self.expand_bn(self.expand_conv(y)))
        y = F.relu6(self.depthwise_bn(self.depthwise_conv(y)))
        y = self.project_bn(self.project_conv(y))
        return x + y if self.residual else y


class MobileNetV2(nn.Module):
    """torchvision's ``mobilenet_v2.features``: NHWC -> (one NHWC map)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.stem_conv = _conv(3, cfg["stem"], 3, 2)
        self.stem_bn = BatchNorm(cfg["stem"])
        cin, i = cfg["stem"], 1
        for t, c, n, s in cfg["blocks"]:
            for b in range(n):
                self.add_module(f"block{i}", InvertedResidual(
                    cin, c, s if b == 0 else 1, t))
                cin, i = c, i + 1
        self.n_blocks = i - 1
        self.head_conv = _conv(cin, cfg["out_channels"], 1)
        self.head_bn = BatchNorm(cfg["out_channels"])

    def forward(self, images):
        x = F.relu6(self.stem_bn(self.stem_conv(images.permute(0, 3, 1, 2))))
        for i in range(1, self.n_blocks + 1):
            x = getattr(self, f"block{i}")(x)
        return (F.relu6(self.head_bn(self.head_conv(x))).permute(0, 2, 3, 1),)


BACKBONES = {"resnet_fpn": ResNetFPN, "mobilenet_v2": MobileNetV2}
# Modules whose outputs the control stores in float8.
STORED = (FrozenBatchNorm, BatchNorm, Bottleneck, InvertedResidual,
          ResNetFPN, MobileNetV2)


class RPNHead(nn.Module):
    def __init__(self, cin, width, anchors):
        super().__init__()
        self.conv = _conv(cin, width, 3, bias=True)
        self.cls_logits = _conv(width, anchors, 1, bias=True)
        self.bbox_pred = _conv(width, anchors * 4, 1, bias=True)

    def forward(self, feats):
        logits, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f.permute(0, 3, 1, 2)))
            B = t.shape[0]
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1).reshape(B, -1))
            deltas.append(self.bbox_pred(t).permute(0, 2, 3, 1)
                          .reshape(B, -1, 4))
        return torch.cat(logits, 1), torch.cat(deltas, 1)


class TwoMLPHead(nn.Module):
    def __init__(self, cin, res, rep):
        super().__init__()
        self.fc6 = Linear(cin * res * res, rep)
        self.fc7 = Linear(rep, rep)

    def forward(self, pooled):
        """pooled [N, 7, 7, C], flattened in CHW order."""
        x = pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1)
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class Predictor(nn.Module):
    def __init__(self, cin, classes):
        super().__init__()
        self.cls_score = Linear(cin, classes)
        self.bbox_pred = Linear(cin, classes * 4)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


class Output(NamedTuple):
    boxes: torch.Tensor      # [B, D, 4] in input coordinates
    scores: torch.Tensor     # [B, D]
    labels: torch.Tensor     # [B, D]
    valid: torch.Tensor      # [B, D]
    rois: torch.Tensor       # [B, P, 4] pooled boxes (invalid zeroed)


def smooth_l1(x, beta):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def balanced_sample(labels, batch_size, fraction, draws):
    """The ``n`` positives (labels 1) and negatives (labels 0) with the
    smallest uniform keys ``draws = (u_pos, u_neg)``, ties to the lower
    index -> (pos mask, neg mask)."""
    pos, neg = labels == 1, labels == 0
    max_pos = int(batch_size * fraction)
    A = labels.shape[-1]

    def pick(mask, cap, n_take, u):
        cap = min(cap, A)
        r = torch.where(mask, u, torch.inf)
        idx = torch.sort(r, dim=-1, stable=True)[1][..., :cap]
        first = torch.arange(cap, device=labels.device) < n_take[..., None]
        return torch.zeros_like(mask).scatter_(-1, idx, first) & mask

    num_pos = pos.sum(-1).clamp(max=max_pos)
    sel_pos = pick(pos, max_pos, num_pos, draws[0])
    num_neg = torch.minimum(neg.sum(-1), batch_size - num_pos)
    return sel_pos, pick(neg, batch_size, num_neg, draws[1])


class Detector(nn.Module):
    """Faster R-CNN over ``cfg`` (a configuration file's dict): its
    ``backbone``, ``rpn_head``, ``box_head`` and ``box_predictor``."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        bb = cfg["backbone"]
        if bb["kind"] in BACKBONES:
            self.backbone = BACKBONES[bb["kind"]](bb)
        else:   # a later configuration's: reference/<kind>.py
            self.backbone = importlib.import_module(
                f"benchmark.reference.{bb['kind']}").Backbone(bb)
        channels = bb.get("fpn_channels", bb.get("out_channels"))
        a = cfg["anchors"]
        self.rpn_head = RPNHead(channels, cfg["rpn"]["head_width"],
                                len(a["sizes"][0]) * len(a["ratios"][0]))
        box = cfg["box"]
        self.box_head = TwoMLPHead(channels, box["resolution"],
                                   box["representation_size"])
        self.box_predictor = Predictor(box["representation_size"],
                                       cfg["num_classes"])

    def features(self, x):
        return self.backbone(x)

    def anchors(self, feats):
        a = self.cfg["anchors"]
        shapes = tuple((int(f.shape[1]), int(f.shape[2])) for f in feats)
        stride = a["first_stride"]
        per_level = ops.grid_anchors(
            shapes, (shapes[0][0] * stride, shapes[0][1] * stride),
            tuple(map(tuple, a["sizes"])), tuple(map(tuple, a["ratios"])))
        return (torch.from_numpy(np.concatenate(per_level)).to(
            feats[0].device), tuple(len(p) for p in per_level))

    def proposals(self, logits, deltas, anchors, per_level, new_hw, train):
        """Per-level top-k, clip, small-box mask, per-level NMS, best
        post-NMS top-k -> (boxes [B, P, 4], valid [B, P])."""
        r = self.cfg["rpn"]
        pre = r["pre_nms_top_n_train" if train else "pre_nms_top_n_test"]
        post = r["post_nms_top_n_train" if train else "post_nms_top_n_test"]
        props = ops.decode_boxes(deltas.detach(), anchors[None],
                                 (1.0, 1.0, 1.0, 1.0))
        obj = logits.detach()
        B = obj.shape[0]
        kmax = max(min(pre, n) for n in per_level)
        scores, boxes, start = [], [], 0
        for n in per_level:
            k = min(pre, n)
            sc, idx = torch.sort(obj[:, start:start + n], dim=1,
                                 descending=True, stable=True)
            sc, idx = sc[:, :k], idx[:, :k]
            if k < kmax:
                sc = torch.cat([sc, sc.new_full((B, kmax - k), ops.NEG_INF)], 1)
                idx = torch.cat([idx, idx.new_zeros(B, kmax - k)], 1)
            scores.append(sc)
            boxes.append(torch.gather(props[:, start:start + n], 1,
                                      idx[..., None].expand(-1, -1, 4)))
            start += n
        scores = torch.stack(scores, 1)
        boxes = torch.stack(boxes, 1)
        hw = new_hw.float()
        boxes = ops.clip_boxes(boxes, hw[:, 0, None, None],
                               hw[:, 1, None, None])
        keep = ((boxes[..., 2] - boxes[..., 0] >= r["min_size"])
                & (boxes[..., 3] - boxes[..., 1] >= r["min_size"]))
        scores = torch.where(keep, scores, torch.full_like(scores, ops.NEG_INF))
        idxs, valid = ops.grouped_nms_presorted(boxes, scores,
                                                r["nms_thresh"], post)
        out = torch.gather(boxes.reshape(B, -1, 4), 1,
                           idxs[..., None].expand(-1, -1, 4))
        return out, valid

    def pool(self, feats, rois):
        levels = self.cfg["roi_align"]["levels"]
        scale = self.cfg["roi_align"].get("spatial_scale")
        return ops.roi_align(feats[:levels], rois, scale,
                             self.cfg["box"]["resolution"],
                             self.cfg["roi_align"]["sampling_ratio"])

    def head(self, pooled):
        B, P = pooled.shape[:2]
        return self.box_predictor(self.box_head(pooled.reshape(B * P,
                                                               *pooled.shape[2:])))

    def _front(self, images, hw, bucket, train):
        x, new_hw = ops.preprocess(images, hw, bucket, self.cfg["min_size"],
                                   self.cfg["max_size"])
        new_hw = torch.from_numpy(new_hw).to(x.device)
        feats = self.features(x)
        logits, deltas = self.rpn_head(feats)
        anchors, per_level = self.anchors(feats)
        props, valid = self.proposals(logits, deltas, anchors, per_level,
                                      new_hw, train)
        return new_hw, feats, logits, deltas, anchors, props, valid

    @torch.no_grad()
    def predict(self, images, hw, bucket) -> Output:
        """images [B, H, W, 3] 0..1 (blurred), ``hw`` host [B, 2]."""
        new_hw, feats, _, _, _, props, valid = self._front(images, hw, bucket,
                                                           False)
        rois = torch.where(valid[..., None], props, torch.zeros_like(props))
        logits, deltas = self.head(self.pool(feats, rois))
        box = self.cfg["box"]
        B, P = props.shape[:2]
        C = logits.shape[-1]
        scores = torch.softmax(logits.reshape(B, P, C), dim=-1)
        boxes = ops.decode_boxes(deltas.reshape(B, P, C, 4), props[:, :, None],
                                 box["coder_weights"])
        hwf = new_hw.float()
        boxes = ops.clip_boxes(boxes, hwf[:, 0, None, None],
                               hwf[:, 1, None, None])
        fg_scores = scores[:, :, 1:].reshape(B, -1)
        fg_boxes = boxes[:, :, 1:].reshape(B, -1, 4)
        fg_labels = torch.arange(1, C, device=scores.device).repeat(P)
        ok = fg_scores > box["score_thresh"]
        ok &= valid.repeat_interleave(C - 1, dim=1)
        ok &= (fg_boxes[..., 2] - fg_boxes[..., 0]) >= 1e-2
        ok &= (fg_boxes[..., 3] - fg_boxes[..., 1]) >= 1e-2
        masked = torch.where(ok, fg_scores,
                             torch.full_like(fg_scores, ops.NEG_INF))
        pool = min(box["nms_pool"], masked.shape[1])
        top, idx = torch.sort(masked, dim=1, descending=True, stable=True)
        top, idx = top[:, :pool], idx[:, :pool]
        cand = torch.gather(fg_boxes, 1, idx[..., None].expand(-1, -1, 4))
        keep, dvalid = ops.batched_nms(cand, top, fg_labels[idx],
                                       box["nms_thresh"],
                                       box["detections_per_img"])
        sel = torch.gather(idx, 1, keep)
        out = torch.gather(fg_boxes, 1, sel[..., None].expand(-1, -1, 4))
        out = ops.resize_boxes(out, new_hw, torch.as_tensor(hw,
                                                             device=out.device))
        zero = torch.zeros((), device=out.device)
        return Output(out, torch.where(dvalid, torch.gather(fg_scores, 1, sel),
                                       zero),
                      torch.where(dvalid, fg_labels[sel], 0), dvalid, rois)

    def loss(self, images, hw, gt_boxes, gt_labels, gt_valid, bucket,
             draws) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The four torchvision losses of a batch (``draws`` the samplers'
        keys: ((rpn u_pos, u_neg), (roi u_pos, u_neg))) and the pooled
        rois [B, S, 4] (unsampled slots zeroed)."""
        cfg, r, box = self.cfg, self.cfg["rpn"], self.cfg["box"]
        hw_t = torch.as_tensor(hw, device=images.device)
        new_hw, feats, logits, deltas, anchors, props, pvalid = self._front(
            images, hw, bucket, True)
        gt = ops.resize_boxes(gt_boxes.float(), hw_t, new_hw)
        gt_valid = gt_valid.bool()
        B = images.shape[0]

        # RPN: Matcher(fg, bg, low-quality matches), balanced sampler.
        iou = ops.box_iou(gt, anchors)
        iou = torch.where(gt_valid[..., None], iou, torch.full_like(iou, -1.0))
        matched, matches = iou.amax(dim=1), iou.argmax(dim=1)
        labels = torch.where(matched >= r["fg_iou_thresh"], 1, -1)
        labels = torch.where(matched < r["bg_iou_thresh"], 0, labels)
        best = iou.amax(dim=2, keepdim=True)
        is_best = (iou == best) & gt_valid[..., None] & (best > 0)
        labels = torch.where(is_best.any(dim=1), 1, labels)
        labels = torch.where(gt_valid.any(dim=1, keepdim=True), labels, 0)
        sel_pos, sel_neg = balanced_sample(labels, r["batch_size_per_image"],
                                           r["positive_fraction"], draws[0])
        sampled = sel_pos | sel_neg
        max_pos = min(int(r["batch_size_per_image"] * r["positive_fraction"]),
                      sel_pos.shape[-1])
        pos_idx = torch.sort(sel_pos.float(), dim=-1, descending=True,
                             stable=True)[1][:, :max_pos]
        pos_ok = torch.gather(sel_pos, 1, pos_idx)
        targets = ops.encode_boxes(
            torch.gather(gt, 1, torch.gather(matches, 1, pos_idx)[..., None]
                         .expand(-1, -1, 4)), anchors[pos_idx],
            (1.0, 1.0, 1.0, 1.0))
        picked = torch.gather(deltas, 1, pos_idx[..., None].expand(-1, -1, 4))
        diff = torch.where(pos_ok[..., None], picked - targets,
                           torch.zeros((), device=picked.device))
        rpn_box = smooth_l1(diff, 1.0 / 9).sum(dim=(1, 2))
        obj_t = labels.to(logits.dtype)
        bce = (logits.clamp(min=0) - logits * obj_t
               + torch.log1p(torch.exp(-logits.abs())))
        rpn_obj = torch.where(sampled, bce, torch.zeros_like(bce)).sum(1)
        n_rpn = sampled.sum(1).clamp(min=1)

        # Box head: proposals + GT, matched at fg/bg IoU, sampled, pooled.
        all_boxes = torch.cat([props, gt], 1)
        all_valid = torch.cat([pvalid, gt_valid], 1)
        iou = ops.box_iou(gt, all_boxes)
        iou = torch.where(gt_valid[:, :, None] & all_valid[:, None, :], iou,
                          torch.full_like(iou, -1.0))
        matched, matches = iou.amax(dim=1), iou.argmax(dim=1)
        fg = matched >= box["fg_iou_thresh"]
        cls = torch.where(fg & all_valid, torch.gather(gt_labels, 1, matches),
                          0)
        tag = torch.where(all_valid, fg.long(), -1)
        any_gt = gt_valid.any(dim=1, keepdim=True)
        tag = torch.where(any_gt, tag, torch.where(all_valid, 0, -1))
        cls = torch.where(any_gt, cls, 0)
        S = box["batch_size_per_image"]
        sel_pos, sel_neg = balanced_sample(tag, S, box["positive_fraction"],
                                           draws[1])
        samp = sel_pos | sel_neg
        prio = torch.where(sel_pos, 0, torch.where(sel_neg, 1, 2))
        slots = torch.argsort(prio, dim=1, stable=True)[:, :S]
        rois = torch.gather(all_boxes, 1, slots[..., None].expand(-1, -1, 4))
        roi_gt = torch.gather(gt, 1, torch.gather(matches, 1, slots)[..., None]
                              .expand(-1, -1, 4))
        roi_valid = torch.gather(samp, 1, slots)
        reg = ops.encode_boxes(roi_gt, rois, box["coder_weights"])
        roi_cls = torch.where(roi_valid, torch.gather(cls, 1, slots), -1)
        rois = torch.where(roi_valid[..., None], rois, torch.zeros_like(rois))
        logits_b, deltas_b = self.head(self.pool(feats, rois))
        C = logits_b.shape[-1]
        logits_b = logits_b.reshape(B, S, C)
        ok = roi_cls >= 0
        safe = roi_cls.clamp(min=0).long()
        ce = -torch.gather(torch.log_softmax(logits_b, -1), 2,
                           safe[..., None])[..., 0]
        ce_sum = torch.where(ok, ce, torch.zeros_like(ce)).sum(1)
        pk = torch.gather(deltas_b.reshape(B, S, C, 4), 2,
                          safe[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
        d = torch.where((roi_cls > 0)[..., None], pk - reg,
                        torch.zeros((), device=pk.device))
        box_sum = smooth_l1(d, 1.0 / 9).sum(dim=(1, 2))
        n_rpn, n_box = n_rpn.sum().clamp(min=1), ok.sum().clamp(min=1)
        return ({"loss_objectness": rpn_obj.sum() / n_rpn,
                 "loss_rpn_box_reg": rpn_box.sum() / n_rpn,
                 "loss_classifier": ce_sum.sum() / n_box,
                 "loss_box_reg": box_sum.sum() / n_box}, rois)
