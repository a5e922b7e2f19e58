"""Scalar logging for the CLIs, on rank 0 only.

Port of ``ScalarWriter`` (``detectinblur_tpu/utils/logging.py:16``): the
path is wiped at start (train.py:109-120 of the reference), scalars go to
TensorBoard, or to ``scalars.jsonl`` where tensorboard is not installed.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional

from detectinblur_tpu_torch.parallel.dist import is_main_process


class ScalarWriter:
    def __init__(self, path: Optional[str]):
        self.writer = None
        self.jsonl = None
        if path is None or not is_main_process():
            return
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self.jsonl = open(os.path.join(path, "scalars.jsonl"), "a")
        else:
            self.writer = SummaryWriter(path)

    def add_scalar(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), step)
        elif self.jsonl is not None:
            self.jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                         "step": step, "ts": time.time()}) + "\n")
            self.jsonl.flush()

    def close(self):
        if self.writer is not None:
            self.writer.close()
        if self.jsonl is not None:
            self.jsonl.close()
