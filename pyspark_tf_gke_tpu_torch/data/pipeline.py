"""Host-side batching and host -> device staging (the port's counterpart
of ``pyspark_tf_gke_tpu/data/pipeline.py``).

* ``train_validation_split`` — the deterministic seeded split (a
  ``np.random.default_rng(seed)`` shuffle, the tail is validation),
  shared by the CSV and image paths;
* ``host_shard`` — process ``i`` keeps rows ``i::count``; one process
  keeps every row;
* ``BatchIterator`` — one seeded shuffle per started epoch, fixed-size
  batches, and ``fast_forward`` to resume mid-epoch after a restore;
* ``put_batch`` / ``prefetch_to_device`` — a background thread turns
  host-local numpy batch dicts into device tensors and keeps up to
  ``size`` of them staged ahead of the consumer: on CUDA each array is
  copied into pinned host memory and then to the card with
  ``non_blocking=True``. Exceptions in the source iterator re-raise at
  the consumer; closing the generator stops the thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.utils.seeding import DEFAULT_SEED, np_rng


def train_validation_split(
    n: int,
    validation_split: float,
    seed: int = DEFAULT_SEED,
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic (train_idx, val_idx): seeded shuffle, the last
    ``n*validation_split`` (clamped to 1..n-1) rows become validation."""
    idx = np.arange(n)
    rng = np_rng(seed)
    rng.shuffle(idx)
    if not validation_split:
        return idx, np.array([], dtype=np.int64)
    val_size = int(n * float(validation_split))
    val_size = max(1, min(n - 1, val_size))
    return idx[:-val_size], idx[-val_size:]


def host_shard(
    *arrays: np.ndarray,
    process_index: int = 0,
    process_count: int = 1,
) -> Tuple[np.ndarray, ...]:
    """Per-process rows, strided like tf.data's ``shard(n, id)``; the port
    trains in one process (index 0 of 1)."""
    if process_count <= 1:
        return arrays
    return tuple(a[process_index::process_count] for a in arrays)


class BatchIterator:
    """Infinite batches over host-local arrays with a full seeded
    permutation per epoch (``shuffle=True``)."""

    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        batch_size: int,
        shuffle: bool = True,
        seed: int = DEFAULT_SEED,
        drop_remainder: bool = True,
    ):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"Array length mismatch: {sizes}")
        self.arrays = arrays
        self.n = next(iter(sizes.values()))
        self.batch_size = batch_size
        if self.n < batch_size and drop_remainder:
            raise ValueError(f"batch_size {batch_size} > dataset size {self.n}")
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._seed = seed
        self._rng = np_rng(seed)
        self._order = np.arange(self.n)
        self._pos = self.n  # trigger reshuffle on first batch

    @property
    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return max(1, self.n // self.batch_size)
        return -(-self.n // self.batch_size)  # ceil: a partial last batch

    def fast_forward(self, consumed_batches: int) -> "BatchIterator":
        """The state after ``consumed_batches`` draws: a resumed run
        continues the exact batch order mid-epoch. Only the seeded
        shuffles are replayed (one per started epoch), no data touched."""
        if consumed_batches < 0:
            raise ValueError(f"consumed_batches must be >= 0, "
                             f"got {consumed_batches}")
        spe = self.steps_per_epoch
        epochs_done, within = divmod(consumed_batches, spe)
        self._rng = np_rng(self._seed)
        self._order = np.arange(self.n)
        if self.shuffle:
            # the lazy reshuffle in __next__ fires at each epoch's first draw
            for _ in range(epochs_done + (1 if within else 0)):
                self._rng.shuffle(self._order)
        # within == 0: the next draw begins a new epoch (and its shuffle)
        self._pos = self.n if within == 0 else within * self.batch_size
        return self

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        epoch_exhausted = (
            self._pos + self.batch_size > self.n
            if self.drop_remainder
            else self._pos >= self.n
        )
        if epoch_exhausted:
            if self.shuffle:
                self._rng.shuffle(self._order)
            self._pos = 0
        end = self._pos + self.batch_size
        if not self.drop_remainder:
            end = min(end, self.n)
        sel = self._order[self._pos:end]
        self._pos = end
        return {k: v[sel] for k, v in self.arrays.items()}


def put_batch(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def prefetch_to_device(batches: Iterator[Dict[str, np.ndarray]],
                       device: torch.device,
                       size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Stream :func:`put_batch`-ed batches with up to ``size`` staged
    ahead (``size=0``: inline)."""
    if size <= 0:
        for b in batches:
            yield put_batch(b, device)
        return

    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    stop = threading.Event()

    def put_or_abort(item) -> bool:
        """Blocking put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not put_or_abort(put_batch(b, device)):
                    return
            put_or_abort(done)
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            put_or_abort(e)

    t = threading.Thread(target=worker, daemon=True, name="device-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # the caller may hand the same source iterator to a new
        # prefetcher (restart-with-resume): two threads on one generator
        # is undefined, so wait for this one to stop
        t.join()
