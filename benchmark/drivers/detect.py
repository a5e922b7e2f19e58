"""Blur-and-detect cells: a closed loop, one call in flight. A call hands
the port one batch of frames from the pool: ``ops/blur.py::batched_blur``
with each frame's PSF, then the detector's ``predict`` in the model
bucket, and copies the detections (boxes, scores, labels, valid) back to
the host. The call's latency runs from its start to the detections on the
host.

``correct``: the reference detector (float32, TF32 off) blurs and detects
the same raw frames with the same PSFs and weights; the detections of the
window's last call on each of ``check_calls`` pool batches drawn from the
seed are held against it (``compare.detections_mismatch``), and the
worst frame is compared with ``det_mismatch``'s limit.
"""

from __future__ import annotations

import math
import random
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import compare, program, traffic
from benchmark.drivers import common
from benchmark.harness import sub_seed
from benchmark.reference import counts
from benchmark.reference import ops as ref_ops


def p95(values) -> float:
    """The 95th percentile of all ``values`` (nearest rank: the smallest
    value with at least 95% of them at or below it)."""
    ordered = sorted(values)
    return ordered[math.ceil(0.95 * len(ordered)) - 1]


class Runner:
    def __init__(self, config: dict, mix: dict, limits: dict, seed: int,
                 device):
        self.cfg, self.mix, self.limits = config, mix, limits
        self.seed, self.device = seed, torch.device(device)
        self.hw = traffic.hw(mix)
        self.bucket = ref_ops.model_bucket(self.hw, config["bucket_min_size"],
                                           config["bucket_max_size"])
        self.exact = config["precision"] == "highest"
        self.kept = {}

    # --------------------------------------------------------- the program
    def setup(self) -> None:
        from detectinblur_tpu_torch.ops.blur import batched_blur

        self._blur = batched_blur
        state = program.start_weights(self.cfg, sub_seed(self.seed, 0),
                                      self.device, self.mix)
        self.model = program.port_model(self.cfg, state, self.device)
        del state
        self.frames = traffic.frames(self.mix, self.seed, self.device)
        self.psfs = traffic.psfs(self.mix, self.seed, self.device)
        self.blurring = torch.ones(self.mix["batch"], dtype=torch.bool,
                                   device=self.device)
        for i in range(self.mix["warmup_calls"]):
            self.call(i)

    def call(self, i: int) -> float:
        """One call on pool batch i % pool; returns the host's seconds
        inside the port's calls (the enqueue)."""
        k = i % self.mix["pool"]
        t0 = time.perf_counter()
        with record_function("bench.blur"):
            blurred = self._blur(self.frames[k].permute(0, 3, 1, 2),
                                 self.psfs[k], self.blurring,
                                 exact=self.exact).permute(0, 2, 3, 1)
        det = self.model.predict(blurred, self.hw, self.bucket)
        host = time.perf_counter() - t0
        self.kept[k] = tuple(t.cpu().numpy() for t in det)
        return host

    def window(self, seconds: float) -> dict:
        lat, host, failed = [], [], 0
        t0 = time.perf_counter()
        end = t0
        i = 0
        while end - t0 < seconds:
            start = time.perf_counter()
            host.append(self.call(i))
            end = time.perf_counter()
            lat.append(end - start)
            boxes, scores, _, valid = self.kept[i % self.mix["pool"]]
            v = valid.astype(bool)
            failed += not (np.isfinite(boxes[v]).all()
                           and np.isfinite(scores[v]).all())
            i += 1
        return {"attempted": i, "failed": failed, "seconds": end - t0,
                "host_ms": [h * 1e3 for h in host],
                "metrics": {"detect_img_s": i * self.mix["batch"] / (end - t0),
                            "detect_ms_p95": p95([x * 1e3 for x in lat])}}

    def trace(self) -> dict:
        return common.profiled(self.call, self.mix["trace_calls"],
                               self.device)

    # ------------------------------------------------------- the reference
    def check(self) -> dict:
        """Frees the program, runs the reference on the sampled batches and
        returns {"checks": {name: {value, limit}}, "rois": [...]}."""
        del self.model
        common.free(self.device)
        state = program.start_weights(self.cfg, sub_seed(self.seed, 0),
                                      self.device, self.mix)
        ref = program.reference_model(self.cfg, state, self.device)
        del state
        rng = random.Random(sub_seed(self.seed, 5))
        done = sorted(self.kept)
        sample = sorted(rng.sample(done, min(self.mix["check_calls"],
                                             len(done))))
        frames, rois = [], []
        for k in sample:
            blurred = ref_ops.blur(self.frames[k].permute(0, 3, 1, 2),
                                   self.psfs[k], self.exact)
            out = ref.predict(blurred.permute(0, 2, 3, 1), self.hw,
                              self.bucket)
            mism = compare.detections_mismatch(
                self.kept[k], [t.cpu().numpy() for t in out[:4]])
            frames.extend(mism.tolist())
            rois.append(out.rois)
        numbers = compare.detect_numbers(frames)
        return {"checks": {k: {"value": v, "limit": self.limits[k]}
                           for k, v in numbers.items() if k in self.limits},
                "rois": rois, "sampled": sample, "numbers": numbers}

    def counts(self, rois) -> dict:
        """The reference's FLOPs a call and RoIAlign bytes a call (from the
        reference's rois on the sampled batches)."""
        C, elem = counts.channels_of(self.cfg), counts.ACT_BYTES[
            self.cfg["precision"]]
        shapes = counts.pooled_shapes(self.cfg, self.bucket)
        fwd = [counts.roi_align_fwd_bytes(r, shapes, C, elem,
                                          counts.spatial_scale(self.cfg))
               for r in rois]
        return {"flops": counts.step_flops(self.cfg, self.mix["batch"],
                                           self.bucket, train=False),
                "roi_fwd": tuple(float(np.mean(v)) for v in zip(*fwd))}
