"""``utils/profiling.py`` on the CPU: ``trace`` writes a Chrome trace of
the host's operators, ``step_timer`` times a block (no device to wait
for), ``device_memory_stats`` returns ``{}`` as JAX's does on a device
without statistics. The CUDA side is in ``test_torch_port_cuda.py``."""

import json
import time

import pytest
import torch

from detectinblur_tpu.utils import profiling as jax_profiling
from detectinblur_tpu_torch.utils.profiling import (
    device_memory_stats,
    step_timer,
    trace,
)


def test_trace_writes_the_host_operators(tmp_path):
    a = torch.randn(64, 64)
    with trace(str(tmp_path / "trace"), device="cpu") as prof:
        b = torch.mm(a, a).relu()
    assert b.shape == (64, 64)
    events = json.load(open(tmp_path / "trace" / "trace.json"))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names and "aten::relu" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_step_timer_and_memory_stats_on_the_cpu():
    with step_timer() as t:
        time.sleep(0.05)
    assert 0.05 <= t.seconds < 5
    x = torch.ones(3)
    with step_timer(sync=x) as t2:
        y = x * 2
    assert y.sum().item() == 6 and 0 <= t2.seconds < 5
    with step_timer(sync="cpu") as t3:
        pass
    assert t3.seconds >= 0
    assert device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}
    # JAX's on its CPU device, which keeps no statistics: also {}.
    assert jax_profiling.device_memory_stats() == {}


def test_trace_raises_what_the_block_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with trace(str(tmp_path / "t"), device="cpu"):
            1 / 0
