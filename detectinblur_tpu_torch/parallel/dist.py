"""Process rank and count for rank-0 I/O and per-process data shards.

Port of ``is_main_process`` (``detectinblur_tpu/parallel/mesh.py:49``)
and the ``jax.process_index()`` / ``jax.process_count()`` calls around it.
The values come from ``torch.distributed`` when a process group is
initialized, else this is the only process. There is no mesh: under DDP
each process drives its own card.
"""

from __future__ import annotations

import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_main_process() -> bool:
    """The rank-0-only I/O gate."""
    return process_index() == 0
