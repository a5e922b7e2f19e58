"""Small cells for the harness's CPU tests: the real configurations at
the published widths, with the resize, the proposal counts and the
traffic cut so that a run fits on a CPU in seconds."""

from __future__ import annotations

import copy
import json
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parents[1]


def config(name: str) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg.update(min_size=64, max_size=96, bucket_min_size=64,
               bucket_max_size=96)
    cfg["rpn"].update(pre_nms_top_n_test=200, post_nms_top_n_test=100,
                      pre_nms_top_n_train=200, post_nms_top_n_train=200,
                      batch_size_per_image=64)
    cfg["box"].update(batch_size_per_image=64, nms_pool=512,
                      detections_per_img=20)
    return cfg


def traffic(name: str) -> dict:
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    mix.update(batch=2, src_hw=[80, 112], low_hw=[5, 7], pool=3,
               trace_calls=2)
    if mix["kind"] == "detect":
        mix.update(warmup_calls=1, check_calls=2)
    else:
        mix["gt"].update(max=4, slots=4)
    return mix


def cell(config_name: str, traffic_name: str, limits: dict):
    return SimpleNamespace(
        name=f"{config_name}.{traffic_name}", config=config(config_name),
        traffic=traffic(traffic_name), limits=limits,
        entry={"chips": 1}, end_to_end=lambda: [], per_layer=lambda: [],
        root=HERE.parent)
