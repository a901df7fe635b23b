"""Host -> device batch staging (the port's counterpart of
``put_global_batch`` and ``prefetch_to_device`` in
``pyspark_tf_gke_tpu/data/pipeline.py``).

A background thread turns host-local numpy batch dicts into device
tensors and keeps up to ``size`` of them staged ahead of the consumer:
on CUDA each array is copied into pinned host memory and then to the
card with ``non_blocking=True``, so the host goes on preparing while
the copy is queued. Exceptions in the source iterator re-raise at the
consumer; closing the generator stops the thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch


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
