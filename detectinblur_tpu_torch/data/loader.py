"""Host-side batch loader with thread prefetch.

Port of ``DetectionLoader`` (``detectinblur_tpu/data/loader.py:33``), in
numpy and threads as there: per-process id sharding padded by
wrap-around, a per-epoch reshuffle (``set_epoch``), orientation
bucketing, ``num_workers`` decode threads and a background thread that
assembles fixed-shape ``BlurBatch`` structs.

Per-item randomness (AugMix, hflip, blur decision) comes from an RNG keyed
on (seed, epoch, process, position in the epoch), so batches are
identical for any worker count and to the JAX loader's.

Two differences from the JAX loader: an exception raised while a batch is
made reaches the consumer (there the iteration just ends early), and a
consumer that stops early (``--early_stop``) stops the background thread.

Each source bucket drops its own leftovers in training, so two processes
whose shards mix aspect ratios differently may make different numbers of
batches. The loader stays as JAX's; ``steps_together`` ends every
process's epoch when the first runs out, so no process waits forever in
a collective of the train step.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from detectinblur_tpu_torch.data import batching
from detectinblur_tpu_torch.data.augmix import augment_and_mix
from detectinblur_tpu_torch.data.blur_sampling import (
    BlurDecision,
    BlurPolicy,
    sample_blur_decision,
)
from detectinblur_tpu_torch.parallel.dist import all_have, process_count

_DONE = object()


class DetectionLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        policy: Optional[BlurPolicy] = None,
        psf_bank: Optional[np.ndarray] = None,
        shuffle: bool = True,
        hflip_prob: float = 0.0,
        source_buckets: Optional[Sequence[Tuple[int, int]]] = None,
        seed: int = 1337,
        max_gt: int = 100,
        num_processes: int = 1,
        process_index: int = 0,
        prefetch: int = 2,
        drop_last: bool = True,
        augmix: Optional[dict] = None,
        num_workers: int = 0,
        pin_memory: bool = False,
    ):
        """``augmix``: keyword arguments of ``data.augmix.augment_and_mix``
        (``positional``, ``modify_target_boxes``), the --non_pos_aug_mix /
        --include_pos_aug_mix / --aug_mix_target_expand flags.
        ``pin_memory``: the background thread pins every tensor of each
        batch (it needs CUDA), so that the step copies them to the card
        without waiting on it (``train/engine.py::to_device``)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.policy = policy or BlurPolicy(prob=0.0)
        self.psf_bank = psf_bank
        self.shuffle = shuffle
        self.hflip_prob = hflip_prob
        if source_buckets is None:
            source_buckets = batching.DEFAULT_SOURCE_BUCKETS
        self.buckets = tuple(source_buckets)
        self.seed = seed
        self.max_gt = max_gt
        self.num_processes = num_processes
        self.process_index = process_index
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.augmix = augmix
        self.num_workers = num_workers
        self.pin_memory = pin_memory
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.num_processes <= 1:
            return idx
        # Per-process contiguous shard, padded to ceil(n/P) by wrapping
        # around like torch's DistributedSampler, so the shards cover every
        # item; the eval merge drops the duplicates by image id.
        per = -(-n // self.num_processes)
        pad = per * self.num_processes - n
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
        return idx[self.process_index * per : (self.process_index + 1) * per]

    def __len__(self):
        return len(self._epoch_indices()) // self.batch_size

    def _prepare(self, pos: int, index: int):
        """Fetch and augment one item with its own (seed, epoch, process,
        position) RNG; self-contained, so workers may run it in any order."""
        rng = np.random.default_rng(
            [abs(self.seed + self.epoch), self.process_index, pos])
        bank_size = self.psf_bank.shape[2] if self.psf_bank is not None else 1
        item = self.dataset[int(index)]
        if self.augmix is not None:
            mixed, boxes = augment_and_mix(item["image"], rng,
                                           boxes=item["boxes"], **self.augmix)
            item = dict(item, image=mixed,
                        boxes=boxes if boxes is not None else item["boxes"])
        if self.hflip_prob > 0 and rng.random() < self.hflip_prob:
            item = batching.hflip_item(item)
        h, w = item["image"].shape[:2]
        bucket = batching.pick_bucket(h, w, self.buckets)
        # Oversized images are top-left-cropped to the largest bucket; GT
        # boxes are clipped to the crop and the ones left degenerate drop.
        if h > bucket[0] or w > bucket[1]:
            item = dict(item, image=item["image"][: bucket[0], : bucket[1]])
            if len(item["boxes"]):
                boxes = item["boxes"].copy()
                boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, bucket[1])
                boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, bucket[0])
                keep = ((boxes[:, 2] > boxes[:, 0])
                        & (boxes[:, 3] > boxes[:, 1]))
                item["boxes"] = boxes[keep]
                for k in ("labels", "area", "iscrowd", "keypoints"):
                    if k in item:
                        item[k] = item[k][keep]
        if item.get("pre_blurred"):
            # Naturally blurred images pass through the blur stage.
            dec = BlurDecision(False, -1, -1, 0)
        else:
            dec = sample_blur_decision(rng, self.policy, bank_size)
        return item, dec, bucket

    def _prepared_items(self) -> Iterator:
        """Prepared (item, dec, bucket) in epoch order, the per-item work
        spread over ``num_workers`` threads when asked."""
        indices = self._epoch_indices()
        if self.num_workers <= 1:
            for pos, i in enumerate(indices):
                yield self._prepare(pos, int(i))
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window = self.num_workers * 2
            futures: "queue.SimpleQueue" = queue.SimpleQueue()
            it = iter(enumerate(indices))
            in_flight = 0
            for pos, i in it:
                futures.put(pool.submit(self._prepare, pos, int(i)))
                in_flight += 1
                if in_flight == window:
                    break
            try:
                while in_flight:
                    done = futures.get()
                    in_flight -= 1
                    yield done.result()
                    for pos, i in it:
                        futures.put(pool.submit(self._prepare, pos, int(i)))
                        in_flight += 1
                        break
            finally:
                while in_flight:   # let no submitted item run unread
                    futures.get().cancel()
                    in_flight -= 1

    def _batches(self) -> Iterator:
        pending: Dict[Tuple[int, int], List] = {b: [] for b in self.buckets}

        def emit(lst, bucket):
            items, decs = zip(*lst)
            batch = batching.build_blur_batch(
                list(items), list(decs), self.psf_bank, bucket, self.max_gt,
                bucket_gt=self.num_processes == 1)
            if self.pin_memory:
                batch = type(batch)(*(t if t is None else t.pin_memory()
                                      for t in batch))
            return batch, bucket, [it["image_id"] for it in items]

        for item, dec, bucket in self._prepared_items():
            pending[bucket].append((item, dec))
            if len(pending[bucket]) == self.batch_size:
                yield emit(pending[bucket], bucket)
                pending[bucket] = []
        if not self.drop_last:
            for bucket, lst in pending.items():
                if lst:
                    yield emit(lst, bucket)

    def _produce(self, out_q: "queue.Queue", stop: threading.Event):
        def put(obj) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(obj, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        batches = self._batches()
        try:
            for got in batches:
                if not put(got):
                    return
            put(_DONE)
        except Exception as e:   # handed to the consumer, raised there
            put(e)
        finally:
            batches.close()

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop), daemon=True)
        t.start()
        try:
            while True:
                got = q.get()
                if got is _DONE:
                    return
                if isinstance(got, Exception):
                    raise got
                yield got
        finally:
            stop.set()
            t.join()


class _Together:
    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        try:
            while True:
                got = next(it, None)
                if not all_have(got is not None):
                    return
                yield got
        finally:
            it.close()


def steps_together(loader):
    """``loader``'s batches while every process has one: before each
    batch the processes agree that each holds one, and all end the epoch
    when one has run out. ``loader`` itself in one process."""
    return loader if process_count() == 1 else _Together(loader)
