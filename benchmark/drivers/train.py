"""Training cells: the port's train step (``train/engine.py::
make_train_step``: the device blur, the PSF-driven GT expansion, the
four losses, the backward and SGD) driven over a pool of staged batches,
each step with the benchmark's sampler keys (``LossDraws``). The losses
stay on the device and are read once the window has closed.

``correct``: set-up builds the one train step and drives it through its
first three steps on three different batches; those steps are the ones
the window continues from. Read from the program: each step's loss, the
first gradient as SGD got it (its momentum buffer after step 1 less the
weight decay of the start weights), and each parameter's change after the
three steps. The reference (float32, TF32 off) trains the same start
weights on the same batches and keys; ``loss_gap``, ``grad_gap`` and
``update_gap`` (``compare.py``) are held against their limits.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, program, traffic
from benchmark.drivers import common
from benchmark.harness import sub_seed
from benchmark.reference import counts
from benchmark.reference import ops as ref_ops
from benchmark.reference.train import sgd_steps

CHECK_STEPS = 3


class Runner:
    def __init__(self, config: dict, mix: dict, limits: dict, seed: int,
                 device):
        self.cfg, self.mix, self.limits = config, mix, limits
        self.seed, self.device = seed, torch.device(device)
        self.hw = traffic.hw(mix)
        self.bucket = ref_ops.model_bucket(self.hw, config["bucket_min_size"],
                                           config["bucket_max_size"])
        self.exact = config["precision"] == "highest"

    def _inputs(self):
        mix, dev = self.mix, self.device
        frames = traffic.frames(mix, self.seed, dev)
        psfs = traffic.psfs(mix, self.seed, dev)
        boxes, labels, valid = traffic.gt(mix, self.seed,
                                          self.cfg["num_classes"], dev)
        B = mix["batch"]
        anchors = counts.anchor_count(self.cfg, self.bucket)
        rois = self.cfg["rpn"]["post_nms_top_n_train"] + mix["gt"]["slots"]
        gen = torch.Generator(device=dev).manual_seed(sub_seed(self.seed, 4))
        draws = []
        for _ in range(mix["pool"]):
            u = [torch.rand(B, n, generator=gen, device=dev)
                 for n in (anchors, anchors, rois, rois)]
            draws.append(((u[0], u[1]), (u[2], u[3])))
        batches = [{"images": frames[k], "hw": torch.from_numpy(self.hw),
                    "psfs": psfs[k],
                    "blurring": torch.ones(B, dtype=torch.bool, device=dev),
                    "gt_boxes": boxes[k], "gt_labels": labels[k],
                    "gt_valid": valid[k]} for k in range(mix["pool"])]
        return batches, draws

    # --------------------------------------------------------- the program
    def setup(self) -> None:
        from detectinblur_tpu_torch.models.faster_rcnn import LossDraws
        from detectinblur_tpu_torch.train.engine import (
            BlurBatch,
            make_train_step,
        )
        from detectinblur_tpu_torch.train.state import (
            create_train_state,
            make_optimizer,
        )

        opt = self.mix["optimizer"]
        state = program.start_weights(self.cfg, sub_seed(self.seed, 0),
                                      self.device, self.mix)
        self.model = program.port_model(self.cfg, state, self.device)
        del state
        optimizer, schedule = make_optimizer(
            self.model, base_lr=opt["base_lr"],
            steps_per_epoch=opt["steps_per_epoch"],
            momentum=opt["momentum"], weight_decay=opt["weight_decay"])
        self.state = create_train_state(self.model, optimizer)
        self.step = make_train_step(self.model, schedule, self.bucket,
                                    blur_train=True, expand_target_boxes=True)
        self.batches, self.draws = self._inputs()
        self.port_batches = [BlurBatch(**b) for b in self.batches]
        self.port_draws = [LossDraws(*d) for d in self.draws]
        self.losses = []

        names = {id(p): n for n, p in self.model.named_parameters()}
        params = {names[id(p)]: p for g in optimizer.param_groups
                  for p in g["params"]}
        start = {n: p.detach().clone() for n, p in params.items()}
        self._restart = (list(params.values()), list(start.values()))
        for i in range(CHECK_STEPS):
            self.call(i)
            if i == 0:
                wd = opt["weight_decay"]
                # A step that left no momentum buffer gave SGD nothing.
                self.port_grad = compare.leaf_norms(
                    {n: optimizer.state[p].get("momentum_buffer",
                                               wd * start[n]) - wd * start[n]
                     for n, p in params.items()})
        self.port_change = compare.leaf_norms(
            {n: p.detach() - start[n] for n, p in params.items()})
        self.port_losses = [{k: float(v) for k, v in m.items()
                             if k != "loss"} for m in self.losses]
        self.next = CHECK_STEPS

    def call(self, i: int) -> float:
        """One train step on pool batch i % pool; returns the host's
        seconds inside the step's call. Each time the pool comes round
        again the job restarts from the start weights, with no momentum
        and the schedule at step 0 (inside the window: it is part of the
        timed work). From random weights the warm-up's rising learning
        rate diverges after a few hundred steps (0.04 x s / 1000: 21 of
        400 losses were non-finite in one 20-second window), and a faster
        program would reach those steps sooner; the restart keeps every
        step's work and state in the range the check holds."""
        k = i % self.mix["pool"]
        t0 = time.perf_counter()
        if k == 0 and i:
            with torch.no_grad():
                torch._foreach_copy_(*self._restart)
            self.state.optimizer.state.clear()
            self.state = self.state._replace(step=0)
        self.state, metrics = self.step(self.state, self.port_batches[k],
                                        draws=self.port_draws[k])
        host = time.perf_counter() - t0
        self.losses.append(metrics)
        return host

    def window(self, seconds: float) -> dict:
        first = len(self.losses)
        host = []
        common.sync(self.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            host.append(self.call(self.next))
            self.next += 1
        common.sync(self.device)
        t = time.perf_counter() - t0
        losses = torch.stack([m["loss"] for m in self.losses[first:]]).cpu()
        steps = len(host)
        return {"attempted": steps,
                "failed": int((~torch.isfinite(losses)).sum()),
                "seconds": t, "host_ms": [h * 1e3 for h in host],
                "metrics": {"train_img_s": steps * self.mix["batch"] / t}}

    def trace(self) -> dict:
        def call(_):
            self.call(self.next)
            self.next += 1
        return common.profiled(call, self.mix["trace_calls"], self.device)

    # ------------------------------------------------------- the reference
    def check(self) -> dict:
        del self.model, self.state, self.step, self.port_batches
        del self._restart
        self.losses = []
        common.free(self.device)
        state = program.start_weights(self.cfg, sub_seed(self.seed, 0),
                                      self.device, self.mix)
        ref = program.reference_model(self.cfg, state, self.device,
                                      torch.float64)
        del state
        steps = sgd_steps(ref, self.batches[:CHECK_STEPS],
                          self.draws[:CHECK_STEPS], self.bucket,
                          self.mix["optimizer"], self.exact)
        ref_grad = compare.leaf_norms(steps.grad)
        numbers = compare.train_numbers(
            self.port_losses, self.port_grad, self.port_change, steps.losses,
            ref_grad, compare.leaf_norms(steps.change))
        checks = {k: v for k, v in numbers.items() if k in self.limits}
        return {"checks": {k: {"value": v, "limit": self.limits[k]}
                           for k, v in checks.items()},
                "rois": steps.rois, "numbers": numbers,
                "worst_grad_leaves": compare.worst_leaves(
                    self.port_grad, ref_grad, compare.moved_leaves(ref_grad))}

    def counts(self, rois) -> dict:
        """The reference's FLOPs a step, and RoIAlign bytes a step from the
        reference's sampled rois of its steps."""
        C, elem = counts.channels_of(self.cfg), counts.ACT_BYTES[
            self.cfg["precision"]]
        shapes = counts.pooled_shapes(self.cfg, self.bucket)
        scale = counts.spatial_scale(self.cfg)
        fwd = [counts.roi_align_fwd_bytes(r, shapes, C, elem, scale)
               for r in rois]
        bwd = [counts.roi_align_bwd_bytes(r, (r != 0).any(-1), shapes, C,
                                          elem, scale) for r in rois]
        return {"flops": counts.step_flops(self.cfg, self.mix["batch"],
                                           self.bucket, train=True),
                "roi_fwd": tuple(float(np.mean(v)) for v in zip(*fwd)),
                "roi_bwd": tuple(float(np.mean(v)) for v in zip(*bwd))}
