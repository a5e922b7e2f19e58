"""Processes of ``tests/test_torch_port_ddp.py``: the port's train steps
and CLIs at W > 1, one spawned process a rank in a gloo group on the CPU.

Spawned processes import this module by name, so it imports torch,
numpy, the port and the repo's torch-only test helpers, never JAX. Each
job runs with one torch thread and returns its result through a queue;
``spawn`` joins every process with a timeout and kills it on expiry, so a
hang fails the test that started it.
"""

from __future__ import annotations

import contextlib
import hashlib
import multiprocessing
import os
import socket
import sys
import traceback
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

# The tiny detector of tests/test_torch_port_cli.py: ResNet50-FPN widths,
# a 96x96 bucket, small RPN and NMS pools, 5 classes.
TINY = dict(min_size=96, max_size=96, num_classes=5)
TINY_RPN = dict(pre_nms_top_n_train=200, post_nms_top_n_train=100,
                pre_nms_top_n_test=200, post_nms_top_n_test=100)
TINY_BOX = dict(batch_size_per_image=64, nms_pool=256, detections_per_img=20)
# Two orientations, so that the ranks' shards make different numbers of
# batches.
SOURCE_BUCKETS = ((72, 96), (96, 72))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def gloo_group(rank: int, world: int, port: int):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _run(job: Callable, rank: int, world: int, payload, out) -> None:
    torch.set_num_threads(1)
    try:
        value = job(rank, world, payload)
        out.put((rank, True, value))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def spawn(job: Callable, payloads: Sequence, timeout: float = 300) -> List:
    """``job(rank, world, payload)`` in one spawned process per payload;
    returns their results by rank. Raises the first error a process
    reports, or ``queue.Empty`` when one gives nothing within
    ``timeout`` seconds; every process is joined, and killed if alive."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    world = len(payloads)
    procs = [ctx.Process(target=_run, args=(job, r, world, p, out))
             for r, p in enumerate(payloads)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, ok, value = out.get(timeout=timeout)
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def digests(module: torch.nn.Module, optimizer=None) -> Dict[str, str]:
    """sha256 of each state-dict tensor's bytes, and with ``optimizer``
    of each momentum buffer (keyed by its parameter's position)."""
    out = {k: _sha(v) for k, v in module.state_dict().items()}
    if optimizer is not None:
        params = [p for g in optimizer.param_groups for p in g["params"]]
        out.update({f"momentum.{i}": _sha(optimizer.state[p][
                        "momentum_buffer"]) for i, p in enumerate(params)
                    if "momentum_buffer" in optimizer.state[p]})
    return out


# ------------------------------------------------------------ train steps
def _batch(rows: Dict[str, np.ndarray]):
    from detectinblur_tpu_torch.train.engine import BlurBatch

    return BlurBatch(**{k: torch.from_numpy(v) for k, v in rows.items()})


def _loss_draws(d):
    from detectinblur_tpu_torch.models.faster_rcnn import LossDraws

    T = torch.from_numpy
    return LossDraws(rpn=(T(d[0]), T(d[1])), roi=(T(d[2]), T(d[3])))


def run_case(case: dict, out_dir: str):
    """One train case on this process: a detector (``make_train_step``)
    or the blur estimator (``make_estimator_train_step``), its weights,
    momentum and step restored from ``case["resume"]`` (a full checkpoint
    written in one process), stepped once per entry of
    ``case["draws"]`` on ``case["batch"]`` (this process's rows), then
    checkpointed into ``out_dir`` (process 0 writes). Returns each step's
    metrics and state digests and the trainable parameters left without
    a gradient."""
    from detectinblur_tpu_torch.train.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from detectinblur_tpu_torch.train.state import TrainState

    batch = _batch(case["batch"])
    if case["kind"] == "detector":
        from detectinblur_tpu_torch.models.faster_rcnn import (
            FasterRCNN,
            FasterRCNNConfig,
        )
        from detectinblur_tpu_torch.models.roi_heads import BoxHeadConfig
        from detectinblur_tpu_torch.models.rpn import RPNConfig
        from detectinblur_tpu_torch.train.engine import make_train_step
        from detectinblur_tpu_torch.train.state import make_optimizer

        cfg = dict(case["config"])
        model = FasterRCNN(FasterRCNNConfig(
            rpn=RPNConfig(**cfg.pop("rpn")),
            box=BoxHeadConfig(**cfg.pop("box")),
            precision="highest", **cfg), device="cpu")
        opt, schedule = make_optimizer(model, **case["optimizer"])
        step = make_train_step(model, schedule, case["bucket"],
                               **case["flags"])
        kw = lambda d: {"draws": _loss_draws(d)}
    else:
        from detectinblur_tpu_torch.models.classifier import ResNetClassifier
        from detectinblur_tpu_torch.train.estimator_engine import (
            make_estimator_train_step,
        )
        from detectinblur_tpu_torch.train.state import make_lr_schedule

        model = ResNetClassifier("resnet18", case["num_classes"], "train",
                                 precision="highest", device="cpu")
        o = case["optimizer"]
        opt = torch.optim.SGD(model.parameters(), lr=o["lr"], momentum=0.9,
                              weight_decay=o["weight_decay"])
        schedule = make_lr_schedule(o["lr"], 1, milestones=(6, 8))
        step = make_estimator_train_step(model, schedule, case["bucket"],
                                         **case["flags"])
        kw = lambda d: {}
    state = restore_checkpoint(case["resume"], TrainState(0, model, opt))
    metrics, states, no_grad = [], [], set()
    for d in case["draws"]:
        state, m = step(state, batch, **kw(d))
        metrics.append({k: v.item() for k, v in m.items()})
        states.append(digests(model, opt))
        no_grad |= {n for n, p in model.named_parameters()
                    if p.requires_grad and p.grad is None}
    save_checkpoint(out_dir, state, 0)
    files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    return dict(metrics=metrics, digests=states, no_grad=sorted(no_grad),
                files=files)


def train_cases(rank: int, world: int, payload) -> List[dict]:
    """Every case of ``payload["cases"]`` in one gloo group (the parent
    passes each rank its rows), checkpoints into
    ``{payload["out"]}/rank{rank}``."""
    assert "jax" not in sys.modules
    out = os.path.join(payload["out"], f"rank{rank}")
    os.makedirs(out, exist_ok=True)
    with gloo_group(rank, world, payload["port"]):
        return [run_case(c, os.path.join(out, str(i)))
                for i, c in enumerate(payload["cases"])]


# ----------------------------------------------------------------- CLIs
def tiny_bank() -> np.ndarray:
    """tests/test_torch_port_cli.py's injected PSF bank."""
    rng = np.random.default_rng(1)
    b = np.zeros((3, 5, 2, 128, 128), np.float32)
    b[:, :, :, 60:68, 60:68] = rng.random((3, 5, 2, 8, 8))
    return b


def build_tiny(args, device):
    """The tiny detector, in the BatchNorm mode ``args`` ask for."""
    from detectinblur_tpu_torch.cli.args import bn_mode_for
    from detectinblur_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
        FasterRCNNConfig,
    )
    from detectinblur_tpu_torch.models.roi_heads import BoxHeadConfig
    from detectinblur_tpu_torch.models.rpn import RPNConfig

    return FasterRCNN(FasterRCNNConfig(
        **TINY, rpn=RPNConfig(**TINY_RPN), box=BoxHeadConfig(**TINY_BOX),
        bn_mode=bn_mode_for(args), precision="highest"), device=device)


def tiny_patches():
    """(module, attribute, value) that make the port's CLIs build the
    tiny detector at one 96x96 model bucket, read the two orientations'
    source buckets and take ``tiny_bank``, as tests/test_torch_port_cli.py's
    ``tiny`` fixture does."""
    import detectinblur_tpu_torch.cli.evaluate as cli_eval
    import detectinblur_tpu_torch.cli.train as cli_train
    import detectinblur_tpu_torch.cli.train_blur_estimator as cli_est
    import detectinblur_tpu_torch.data.batching as batching

    bank = tiny_bank()
    patches = [(batching, "DEFAULT_SOURCE_BUCKETS", SOURCE_BUCKETS),
               (cli_est, "model_bucket_for", lambda b: (96, 96))]
    for mod in (cli_train, cli_eval, cli_est):
        patches.append((mod, "generate_psf_bank", lambda *a, **k: bank))
    for mod in (cli_train, cli_eval):
        patches += [(mod, "build_model", build_tiny),
                    (mod, "model_bucket_for_batch", lambda hw, **kw: (96, 96))]
    return patches


def run_clis(rank: int, world: int, payload) -> dict:
    """``cli.train``, ``cli.evaluate`` and ``cli.train_blur_estimator`` as
    ``torchrun`` starts them: the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; a
    port a CLI), each CLI making and destroying its own gloo group
    (``--device cpu``). Each rank writes into its own output directory,
    so the parent sees which rank wrote. Returns what each CLI gave."""
    assert "jax" not in sys.modules
    import detectinblur_tpu_torch.cli.evaluate as cli_eval
    import detectinblur_tpu_torch.cli.train as cli_train
    import detectinblur_tpu_torch.cli.train_blur_estimator as cli_est
    from detectinblur_tpu_torch.parallel.dist import distributed

    for mod, name, value in tiny_patches():
        setattr(mod, name, value)
    root, out = payload["coco"], payload["out"]
    got = {}
    for (name, main, argv), port in zip((
            ("train", cli_train.main, payload["train"]),
            ("evaluate", cli_eval.main, payload["evaluate"]),
            ("estimator", cli_est.main, payload["estimator"])),
            payload["ports"]):
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        d = os.path.join(out, f"{name}_rank{rank}")
        result = main(["--data-path", root, "--device", "cpu",
                       "--output_dir", d, "--workers", "0", *argv])
        assert not distributed(), f"{name} left its group behind"
        files = sorted(os.listdir(d)) if os.path.isdir(d) else []
        if name == "evaluate":
            got[name] = dict(stats=np.asarray(result))
        else:
            got[name] = dict(step=result.state.step, losses=result.losses,
                             digests=digests(result.state.model), files=files)
            if name == "train":
                got[name]["evals"] = result.evals
            else:
                got[name]["top1"] = result.top1
    return got
