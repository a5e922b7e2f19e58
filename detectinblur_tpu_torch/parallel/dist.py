"""Data parallelism across processes: one process per card, launched by
``torchrun``.

Port of ``detectinblur_tpu/parallel/mesh.py``. JAX runs one SPMD program
over a batch-sharded mesh; here each process drives its own card, reads
its own shard (``data/loader.py``), and the processes meet in
``torch.distributed`` collectives: the gradient all-reduce of DDP
(``train/engine.py``), the global sums of train-mode BatchNorm and of the
detector's sampled counts (``all_reduce_sum``), the eval merge
(``train/eval_loop.py``), and the agreements of the train loops
(``agree_max``, ``all_have``).

``init_distributed`` follows the reference's ``init_distributed_mode``
(SURVEY §2.6): the launcher's ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``,
``--dist-url`` as the ``init_method``, NCCL for a CUDA device and gloo
for the CPU. A group the caller initialized is used as it is. With no
group initialized every helper here is the identity, and the
single-process path does exactly what it did without them.
"""

from __future__ import annotations

import contextlib
import os
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn


def distributed() -> bool:
    """True while a process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if distributed() else 1


def is_main_process() -> bool:
    """The rank-0-only I/O gate."""
    return process_index() == 0


def local_rank() -> int:
    """The launcher's ``LOCAL_RANK`` (the card of this process on its
    host), else the rank."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def launch_env(world_size: int, environ: Mapping[str, str]
               ) -> Optional[Tuple[int, int, int]]:
    """(rank, world size, local rank) from a launcher's environment, or
    None for one process. ``world_size`` is ``--world-size``: 1, the
    default, takes the launcher's count; another value must equal it, and
    without a launcher it raises, naming the launch command."""
    if "RANK" in environ and "WORLD_SIZE" in environ:
        rank, world = int(environ["RANK"]), int(environ["WORLD_SIZE"])
        if world_size > 1 and world_size != world:
            raise ValueError(f"--world-size {world_size} disagrees with the "
                             f"launcher's WORLD_SIZE={world}")
        return rank, world, int(environ.get("LOCAL_RANK", rank))
    if world_size > 1:
        raise RuntimeError(
            f"--world-size {world_size} needs one process per card, started "
            f"by the launcher: torchrun --nproc_per_node {world_size} -m "
            "detectinblur_tpu_torch.cli.<train|evaluate|"
            "train_blur_estimator> ...")
    return None


def init_distributed(args, device) -> bool:
    """Join the process group the launcher describes (``args.world_size``,
    ``args.dist_url``), NCCL when ``device`` is a CUDA device and gloo
    otherwise. Returns True when this call created the group, which the
    caller then destroys; False for one process or a group the caller had
    initialized, which is used as it is."""
    if distributed():
        world = dist.get_world_size()
        if args.world_size > 1 and args.world_size != world:
            raise ValueError(f"--world-size {args.world_size} disagrees with "
                             f"the process group's {world} processes")
        return False
    env = launch_env(args.world_size, os.environ)
    if env is None:
        return False
    rank, world, local = env
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank_device(device, local))
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=args.dist_url, world_size=world,
                            rank=rank)
    print(f"process {rank} of {world} ({dist.get_backend()}, "
          f"local rank {local})")
    return True


@contextlib.contextmanager
def process_group(args, device):
    """``init_distributed`` while open; the group it created is destroyed
    on the way out."""
    created = init_distributed(args, device)
    try:
        yield
    finally:
        if created:
            dist.destroy_process_group()


def rank_device(device, local: int) -> torch.device:
    """A process's device under a group: plain ``cuda`` is card ``local``;
    ``cuda:K`` (two processes may share a card) and ``cpu`` stay as
    given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local)
    return dev


def _comm_device() -> torch.device:
    """Where a collective's tensor lives: the current card under NCCL,
    the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the processes, differentiable: its backward
    sums the cotangents over the processes in turn. ``t`` itself without
    a group."""
    if not distributed():
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


def agree_max(values: Sequence[int]) -> Tuple[int, ...]:
    """Each of ``values`` at its maximum over the processes."""
    if not distributed():
        return tuple(values)
    t = torch.tensor(list(values), dtype=torch.int64, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return tuple(int(v) for v in t.tolist())


def all_have(flag: bool) -> bool:
    """True when ``flag`` holds on every process."""
    if not distributed():
        return flag
    t = torch.tensor([int(flag)], device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def barrier() -> None:
    if distributed():
        dist.barrier()


class _Call(nn.Module):
    """DDP's module: ``forward(fn)`` runs ``fn(model)``, so the train step
    calls ``model.loss`` with its own arguments inside DDP's forward, and
    DDP moves none of them (``hw`` stays on the host)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn):
        return fn(self.model)


def data_parallel(model: nn.Module):
    """``model`` in ``DistributedDataParallel`` under a group, made once a
    model and shared by its train steps (each bucket has one); None
    without a group. Its frozen parameters (``requires_grad=False``) stay
    out of the gradient all-reduce, and no buffer is broadcast: train-mode
    BatchNorm's statistics are global already."""
    if not distributed():
        return None
    ddp = model.__dict__.get("_data_parallel")
    if ddp is None:
        dev = next(model.parameters()).device
        ids = None
        if dev.type == "cuda":
            ids = [dev.index if dev.index is not None
                   else torch.cuda.current_device()]
        ddp = nn.parallel.DistributedDataParallel(
            _Call(model), device_ids=ids, broadcast_buffers=False)
        # Not a submodule: the model's state dict stays its own.
        model.__dict__["_data_parallel"] = ddp
    return ddp


def sum_metrics(metrics: Mapping[str, torch.Tensor]) -> dict:
    """Each detached scalar of ``metrics`` summed over the processes, in
    one all-reduce."""
    if not distributed():
        return dict(metrics)
    t = torch.stack([v.detach().float() for v in metrics.values()])
    dev = t.device
    t = t.to(_comm_device())
    dist.all_reduce(t)
    return dict(zip(metrics, t.to(dev).unbind()))
