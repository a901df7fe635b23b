"""Runtime collectors: process and device gauges (the counterpart of
``pyspark_tf_gke_tpu/obs/runtime.py``).

Everything here is pull-model: :func:`install_runtime_metrics` wires
lazy gauges (:meth:`Gauge.set_function`) read at scrape time, and every
collector is guarded, so a CPU-only run or a host with no ``/proc``
still exposes the family (value 0) instead of breaking ``/metrics``.

The family NAMES are the JAX package's, ``runtime_jax_device_count`` and
``runtime_live_array_bytes`` included, so a torch replica's ``/metrics``
carries the same family set as a JAX one; their collectors and help
strings are about this process's torch device.
"""

from __future__ import annotations

import os
import resource
import time
from typing import Optional

import torch

from pyspark_tf_gke_tpu_torch.obs.metrics import (MetricsRegistry,
                                                  get_registry)

_START_TIME = time.time()


def process_rss_bytes() -> int:
    """Resident set size: ``/proc/self/statm`` where available (exact
    current RSS), ``ru_maxrss`` (the peak) as the fallback."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        pass
    try:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:  # noqa: BLE001 — collector, never raises out
        return 0


def device_count() -> int:
    """CUDA devices visible to this process (0 without a card)."""
    try:
        return torch.cuda.device_count()
    except Exception:  # noqa: BLE001
        return 0


def live_device_bytes() -> int:
    """Bytes held by live tensors on the current CUDA device
    (``torch.cuda.memory_allocated``; 0 on the CPU or before CUDA
    initialised — the collector never initialises it)."""
    try:
        if not torch.cuda.is_initialized():
            return 0
        return int(torch.cuda.memory_allocated())
    except Exception:  # noqa: BLE001
        return 0


def install_runtime_metrics(
        registry: Optional[MetricsRegistry] = None) -> dict:
    """Register the ``runtime_`` gauge family as scrape-time collectors;
    idempotent (a re-install re-points the callables). Returns the
    handles."""
    r = registry if registry is not None else get_registry()
    rss = r.gauge("runtime_process_rss_bytes",
                  "Resident set size of this process")
    rss.set_function(process_rss_bytes)
    devs = r.gauge("runtime_jax_device_count",
                   "CUDA devices visible to this process "
                   "(torch.cuda.device_count(); the JAX replica's name)")
    devs.set_function(device_count)
    live = r.gauge("runtime_live_array_bytes",
                   "Bytes held by live tensors on the CUDA device "
                   "(torch.cuda.memory_allocated(); 0 on the CPU)")
    live.set_function(live_device_bytes)
    up = r.gauge("runtime_uptime_seconds",
                 "Seconds since this module was first imported")
    up.set_function(lambda: time.time() - _START_TIME)
    return {"runtime_process_rss_bytes": rss,
            "runtime_jax_device_count": devs,
            "runtime_live_array_bytes": live,
            "runtime_uptime_seconds": up}
