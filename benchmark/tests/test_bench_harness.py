"""CPU tests of the benchmark's harness: names resolve to files, traffic
follows its seed, the statistics and byte counts, the reference against
the port, the import rules.

    python -m pytest benchmark/tests -q

Tests that need a card carry the ``gpu`` marker and skip themselves where
there is none.
"""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, harness, trace, traffic
from benchmark.drivers.detect import p95
from benchmark.reference import counts
from benchmark.tests import tiny

ROOT = harness.ROOT
BENCH = ROOT / "benchmark"


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


# ------------------------------------------------------------- by name
@pytest.mark.parametrize("cell", [w["name"] for w in _spec()["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = harness.Cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert harness.driver(c.traffic["kind"]).Runner
    assert c.limits and all(isinstance(v, float) for v in c.limits.values())
    assert c.end_to_end() and c.per_layer()
    assert "setup_s" in {m["name"] for m in c.end_to_end()}


@pytest.mark.parametrize("metric", [m["name"] for m in _spec()["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


def test_new_files_are_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric added as files and entries are found; no file changes."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = _spec()
    cfg = json.loads((BENCH / "configs" / "frcnn_r50_fpn.json").read_text())
    cfg["name"] = "new_config"
    (tmp_path / "benchmark" / "configs" / "new_config.json").write_text(
        json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "detect_b8.json").read_text())
    mix["batch"] = 4
    (tmp_path / "benchmark" / "traffic" / "new_mix.json").write_text(
        json.dumps(mix))
    (tmp_path / "benchmark" / "limits" / "new_config.new_mix.json"
     ).write_text(json.dumps({"det_mismatch": 0.5}))
    (tmp_path / "benchmark" / "metrics" / "new_metric.detect.py").write_text(
        "def read(rec):\n    return 42.0\n")
    spec["configs"].append({"name": "new_config", "source": "x",
                            "file": "benchmark/configs/new_config.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "new_config.new_mix",
                              "config": "new_config", "traffic": "new_mix",
                              "chips": 1, "why": "x"})
    for m in spec["end_to_end"]:
        if "detect_b8" in str(m.get("workloads")):
            m["workloads"].append("new_config.new_mix")
    spec["per_layer"].append({"name": "new_metric.detect", "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "x", "moves": "detect_img_s",
                              "workloads": ["new_config.new_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    c = harness.Cell("new_config.new_mix", tmp_path)
    assert c.config["name"] == "new_config" and c.traffic["batch"] == 4
    assert c.limits == {"det_mismatch": 0.5}
    names = [m["name"] for m in c.per_layer()]
    assert "new_metric.detect" in names
    assert harness.reader("new_metric.detect", tmp_path)({}) == 42.0
    assert {m["name"] for m in c.end_to_end()} == {
        "detect_img_s", "detect_ms_p95", "setup_s"}


# --------------------------------------------------------------- traffic
@pytest.mark.parametrize("mix", ["detect_b8", "train_b8", "detect_b1_720p"])
def test_traffic_follows_its_seed(mix):
    m = tiny.traffic(mix)
    cpu = torch.device("cpu")

    def draw(seed):
        out = [traffic.frames(m, seed, cpu), traffic.psfs(m, seed, cpu)]
        if "gt" in m:
            out += list(traffic.gt(m, seed, 91, cpu))
        return out

    a, b, c = draw(2 ** 33 + 5), draw(2 ** 33 + 5), draw(7)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        assert x.shape == z.shape and not torch.equal(x, z)
    psf = a[1]
    assert psf.shape[-2:] == (128, 128) and bool((psf >= 0).all())


# ------------------------------------------------------------ statistics
def test_p95_is_taken_over_all_calls():
    assert p95(list(range(1, 101))) == 95
    assert p95([5.0] * 95 + [100.0] * 5) == 5.0
    assert p95([5.0] * 94 + [100.0] * 6) == 100.0
    assert p95([3.0]) == 3.0


def _ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_idle_share_is_the_union_of_intervals():
    events = [
        _ev("user_annotation", "bench.traced_window", 0, 100),
        _ev("user_annotation", "predict.backbone", 0, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=3),
        _ev("kernel", "a", 10, 20, corr=1, tid=7),     # 10-30
        _ev("kernel", "b", 20, 20, corr=2, tid=7),     # 20-40, overlaps a
        _ev("kernel", "c", 70, 10, corr=3, tid=7),     # 70-80
    ]
    ops, ranges, cpu_ops = trace.parse(events)
    rec = {"ops": ops, "calls": 2, "span_us": 100.0,
           "busy_us": trace.busy_us(ops, (0.0, 100.0))}
    assert rec["busy_us"] == 40.0
    assert trace.idle_pct(rec) == pytest.approx(60.0)
    assert trace.range_ms(rec, "predict.backbone") == pytest.approx(0.02)
    assert trace.kernel_ms(rec, ("c",)) == pytest.approx(0.005)
    assert trace.idle_gaps(ops, (0.0, 100.0)) == [(0.0, 10.0), (40.0, 70.0),
                                                  (80.0, 100.0)]


# ---------------------------------------------------------- byte counts
def test_roi_align_bytes_on_a_hand_checked_roi():
    """One roi [0, 0, 32, 32] at 1/32 on a 10x10 map is one cell wide: its
    14 x 14 samples lie inside cell (0, 0) and blend rows and columns 0
    and 1, so 4 cells are read; 49 outputs of C channels are written."""
    rois = torch.tensor([[[0.0, 0.0, 32.0, 32.0]]])
    nbytes, flops = counts.roi_align_fwd_bytes(rois, [(10, 10)], 8, 2,
                                               1 / 32)
    assert nbytes == 49 * 8 * 2 + 4 * 8 * 2
    assert flops == 49 * 8 * 32
    nbytes, _ = counts.roi_align_bwd_bytes(rois, torch.tensor([[True]]),
                                           [(10, 10)], 8, 2, 1 / 32)
    assert nbytes == 49 * 8 * 2 + 4 * 8 * 4 * 2
    nbytes, _ = counts.roi_align_bwd_bytes(rois, torch.tensor([[False]]),
                                           [(10, 10)], 8, 2, 1 / 32)
    assert nbytes == 49 * 8 * 2


def test_reference_flop_count_is_the_cells_shapes():
    cfg = tiny.config("frcnn_r50_fpn")
    fwd = counts.step_flops(cfg, 2, (64, 96), train=False)
    step = counts.step_flops(cfg, 2, (64, 96), train=True)
    assert 0 < fwd < step < 4 * fwd


# --------------------------------------------------- the detection match
def test_frame_mismatch_weighs_scores():
    box = np.array([[0.0, 0.0, 10.0, 10.0]])
    one = np.array([1])
    assert compare.frame_mismatch(box, np.array([0.8]), one, box,
                                  np.array([0.8]), one) == 0.0
    assert compare.frame_mismatch(box, np.array([0.6]), one, box,
                                  np.array([0.8]), one) == pytest.approx(
                                      0.2 / 1.4)
    assert compare.frame_mismatch(box, np.array([0.8]), np.array([2]), box,
                                  np.array([0.8]), one) == 1.0
    assert compare.frame_mismatch(box + 20, np.array([0.8]), one, box,
                                  np.array([0.8]), one) == 1.0


# ------------------------------------------------- imports, by whole name
def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        names = set(_imports(f))
        assert not names & {"jax", "jaxlib", "flax", "detectinblur_tpu"}, f
        if "reference" in f.relative_to(BENCH).parts:
            assert "detectinblur_tpu_torch" not in names, f
    # The check compares whole names: the port's name begins with JAX's.
    assert "detectinblur_tpu_torch".startswith("detectinblur_tpu")
    for cfg in (BENCH / "configs").glob("*.json"):
        prog = json.loads(cfg.read_text())["program"]
        for path in (prog["model"], prog["config"], *prog["nested"].values()):
            assert path.split(".")[0] == "detectinblur_tpu_torch"


def test_a_run_loads_no_jax():
    """The harness's own imports and a tiny run's load neither JAX nor the
    JAX package (a process of its own: the test session has JAX)."""
    code = ("import sys, torch\n"
            "from benchmark.tests import tiny\n"
            "from benchmark.run import run_cell\n"
            "from benchmark import harness\n"
            "torch.set_num_threads(2)\n"
            "c = tiny.cell('frcnn_r50_fpn', 'detect_b8', "
            "{'det_mismatch': 1.0})\n"
            "run_cell(c, 5, 0.1, True, torch.device('cpu'), 0.0)\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(monkeypatch):
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "frcnn_r50_fpn.detect_b8", "--seed", "1",
                     "--seconds", "1"]) == 2


def test_bare_directory_fails(tmp_path):
    """A checkout holding only BENCHMARK.json and benchmark/ has no
    program to run: the command exits non-zero and prints no result."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys, torch\n"
            "from benchmark.tests import tiny\n"
            "from benchmark.run import run_cell\n"
            "c = tiny.cell('frcnn_r50_fpn', 'detect_b8', "
            "{'det_mismatch': 1.0})\n"
            "print(run_cell(c, 5, 0.1, False, torch.device('cpu'), 0.0))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "detectinblur_tpu_torch" in out.stderr


@pytest.mark.gpu
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "frcnn_r50_fpn.detect_b8", "--seed", "2", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
