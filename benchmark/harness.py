"""What every cell's run shares: the checkout's files found by name, the
cache directories, the seeds, the card's identity and peaks, and the
result line.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
harness finds ``benchmark/configs/<config>.json`` through the
configuration's ``file``, ``benchmark/traffic/<traffic>.json``,
``benchmark/limits/<cell>.json`` (the limits of its correctness check),
``benchmark/drivers/<kind>.py`` for the traffic's ``kind``, and
``benchmark/metrics/<metric>.py`` for each per-layer metric. A new cell,
mix, configuration or metric is new files and new entries; no file here
changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "detectinblur_tpu")

# Dense peaks of one card by the name ``torch.cuda.get_device_name`` gives
# (NVIDIA H100 data sheet, SXM, without sparsity, at the 700 W limit):
# bfloat16 tensor cores, float32 outside them, HBM bandwidth. Copied from
# ``detectinblur_tpu_torch/bench/common.py::PEAK_BF16_FLOPS`` and
# ``chip_smoke.py``'s ``HBM_BYTES_PER_S`` / ``F32_OPS_PER_S``.
PEAKS = {
    "H100 80GB HBM3": {"bf16_flops_s": 989.4e12, "f32_flops_s": 67e12,
                       "hbm_bytes_s": 3.35e12},
}


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a cell's first run there builds: the port's nvcc builds
    already land in ``detectinblur_tpu_torch/csrc/build``."""
    base = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(base / sub)
    os.environ.setdefault("USE_FLAX", "0")


def process_start() -> float:
    """Wall-clock time at which this process started (``/proc``)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def sub_seed(seed: int, k: int) -> int:
    """The ``k``-th stream of ``seed``: one per kind of draw."""
    return (int(seed) * 1_000_003 + 7919 * k) % (2 ** 63)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's entry, configuration, traffic, limits and metrics."""

    def __init__(self, name: str, root: Path = ROOT):
        self.spec = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config = load_json(root / configs[self.entry["config"]]["file"])
        self.traffic = load_json(root / "benchmark" / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.limits = load_json(root / "benchmark" / "limits"
                                / f"{name}.json")
        self.root = root

    def _reports(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def end_to_end(self) -> List[dict]:
        return [m for m in self.spec["end_to_end"] if self._reports(m)]

    def per_layer(self) -> List[dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if m["moves"] in e2e and self._reports(m)]


def driver(kind: str):
    """``benchmark/drivers/<kind>.py``."""
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(metric: str, root: Path = ROOT):
    """The ``read(record)`` of ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of card 0, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def peaks(kind: str) -> Optional[Dict[str, float]]:
    for name, p in PEAKS.items():
        if name.lower() in kind.lower():
            return p
    return None

