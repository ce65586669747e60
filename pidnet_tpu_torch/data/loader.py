"""Batch loader with background prefetch (counterpart of
pidnet_tpu/data/loader.py).

In place of torch's DataLoader (reference tools/train.py:96-102):
shuffling, fixed-shape NHWC numpy batches, drop_last, and a worker thread
pool that overlaps the augmentation pipeline with the device's steps.
Threads, not processes: numpy and zlib release the GIL for their heavy
loops, and batches stay host arrays that the engine moves to the card.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 2,
        seed: int = 304,
        prefetch: int = 2,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        """`batch_size` is per-process. With `num_shards > 1` (one shard per
        host process in multi-host training) each process iterates a
        rank-strided subset of a SHARED shuffle (same seed on every rank),
        padded by wrap-around so all ranks see the same number of batches —
        torch DistributedSampler semantics behind the reference's
        `sampler.set_epoch` hook (tools/train.py:176-178)."""
        assert 0 <= shard_index < num_shards
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.seed = seed
        self.epoch = 0
        self._next_epoch: int | None = None
        self._skip = 0
        # Wrap-pad accounting (engine.validate uses it to mask duplicate
        # samples out of the confusion matrices so multi-process mIoU is
        # exact): with num_shards > 1 the padded positions n..n+n_pad-1
        # land round-robin on ranks n%S.., i.e. AT MOST ONE duplicate per
        # rank, always the LAST sample of that rank's epoch order.
        n = len(dataset)
        n_pad = (-n % num_shards) if num_shards > 1 else 0
        n_local = (n + n_pad) // num_shards if num_shards > 1 else n
        n_dup = sum(
            1 for p in range(n, n + n_pad) if p % num_shards == shard_index
        )
        #: real (non-duplicate) samples this rank contributes per epoch
        self.samples_per_epoch = n_local - n_dup

    def set_epoch(self, epoch: int) -> None:
        """Pin the NEXT iteration's epoch number (torch DistributedSampler
        semantics). The shuffle order and the dataset's augmentation stream
        are pure functions of (seed, epoch), so a resumed process replays
        the interrupted epoch's exact sample order — the property
        iteration-exact preemption resume needs (tools/train.py). Without
        set_epoch, __iter__ advances an internal counter as before."""
        self._next_epoch = int(epoch)

    def skip_batches(self, n: int) -> None:
        """Skip the first `n` batches of the NEXT iteration only — without
        decoding their samples (resume-from-mid-epoch fast path). The
        consumer is expected to number its steps accordingly."""
        self._skip = int(n)

    def _shard_order(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            # per-(seed, epoch) stream: deterministic regardless of how
            # many epochs this process already iterated (a resumed process
            # reproduces epoch k's order exactly), identical across ranks
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        if self.num_shards == 1:
            return order
        n_pad = -len(order) % self.num_shards
        if n_pad:  # wrap-around pad so every rank gets the same count
            order = np.concatenate([order, order[:n_pad]])
        return order[self.shard_index :: self.num_shards]

    def __len__(self) -> int:
        n = len(self.dataset)
        n = -(-n // self.num_shards) if self.num_shards > 1 else n
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self, skip: int = 0):
        order = self._shard_order()
        stop = (
            len(order) - len(order) % self.batch_size
            if self.drop_last
            else len(order)
        )
        for start in range(skip * self.batch_size, stop, self.batch_size):
            yield order[start : start + self.batch_size]

    def _collate(self, samples):
        if len(samples[0]) == 3:  # test split: (image, size, name)
            imgs, sizes, names = zip(*samples)
            return np.stack(imgs), np.stack(sizes), list(names)
        imgs, labels, edges, sizes, names = zip(*samples)
        return (
            np.stack(imgs).astype(np.float32),
            np.stack(labels).astype(np.int32),
            np.stack(edges).astype(np.float32),
            np.stack(sizes),
            list(names),
        )

    def __iter__(self):
        if self._next_epoch is not None:
            self.epoch = self._next_epoch
            self._next_epoch = None
        else:
            self.epoch += 1
        skip, self._skip = self._skip, 0
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        out: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # Bounded put that aborts when the consumer abandons iteration:
            # a plain out.put() would block forever on a full queue after
            # the consumer breaks, leaking this thread and its pool.
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # Worker/collate exceptions are shipped through the queue and
            # re-raised in the consuming thread (torch DataLoader
            # semantics, reference tools/train.py:96-102) — never swallowed
            # into a silent hang.
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx_batch in self._batches(skip):
                        if stop.is_set():
                            return
                        samples = list(
                            pool.map(self.dataset.__getitem__, idx_batch)
                        )
                        if not put(self._collate(samples)):
                            return
                put(None)
            except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
                put(_WorkerError(e))

        t = threading.Thread(target=produce, daemon=True)
        self._producer = t  # exposed for tests
        t.start()
        try:
            while True:
                batch = out.get()
                if batch is None:
                    break
                if isinstance(batch, _WorkerError):
                    raise batch.exc
                yield batch
        finally:
            stop.set()
            # Drain so a producer blocked mid-put observes stop promptly.
            try:
                while True:
                    out.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10.0)


class _WorkerError:
    """Queue envelope carrying a producer-side exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc
