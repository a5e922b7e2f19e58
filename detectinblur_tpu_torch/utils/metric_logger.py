"""Windowed metric logging.

Port of ``detectinblur_tpu/utils/metric_logger.py``: ``SmoothedValue``
keeps a deque window with median and mean plus a global count and total;
``MetricLogger.log_every`` prints iteration and data times, the ETA and,
once CUDA is in use, the peak memory the caching allocator handed out
(``torch.cuda.max_memory_allocated``). ``synchronize_between_processes``
sums [count, total] over the process group with
``torch.distributed.all_reduce``; it does nothing in a single process.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist

from detectinblur_tpu_torch.parallel.dist import process_count


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        if process_count() == 1:
            return
        # Under NCCL on the process's own card, which resolve_device made
        # the current one.
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else "cpu")
        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device=device)
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                where = f"[{i}]"
                if total:
                    eta = datetime.timedelta(
                        seconds=int(iter_time.global_avg * (total - i)))
                    where = f"[{i}/{total}] eta: {eta}"
                mem = ""
                if torch.cuda.is_initialized():
                    mem = f" max mem: {torch.cuda.max_memory_allocated() / 2**20:.0f} MB"
                print(f"{header} {where} {self} time: {iter_time} "
                      f"data: {data_time}{mem}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))}")
