"""A body captured as one CUDA graph, with the kernels' launch counters
kept true under replay.

The launch counters (``paged_attention.launches``, ``layernorm.launches``,
``int8_matmul.launches`` and K1's ``variant_launches``) are Python
integers a wrapper bumps where
it launches its kernel. A capture records the launches without running
them, and a replay runs them without Python, so :func:`capture` undoes
the counters' moves during capture and :meth:`Captured.replay` adds them
back on every replay. ``replays`` counts the replays themselves.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

from pyspark_tf_gke_tpu_torch.ops import int8_matmul as _im
from pyspark_tf_gke_tpu_torch.ops import layernorm as _ln
from pyspark_tf_gke_tpu_torch.ops import paged_attention as _pa

# the counters of the kernels a decode or spec chunk runs (K1, K3, K6)
_COUNTERS = ((_pa, "launches"), (_ln, "launches"), (_im, "launches"))

replays = 0  # graph replays since import (a caller may reset it)

# one warm-up stream a device, shared by every capture: a stream's first
# cuBLAS call allocates a workspace that lives as long as the process, so
# a new stream a capture would leak one workspace an engine rebuild
_warmup_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def counter_values() -> list:
    return ([getattr(mod, attr) for mod, attr in _COUNTERS]
            + [dict(_pa.variant_launches)])


def add_counters(delta: list, sign: int = 1) -> None:
    for (mod, attr), d in zip(_COUNTERS, delta):
        setattr(mod, attr, getattr(mod, attr) + sign * d)
    for name, d in delta[-1].items():
        _pa.variant_launches[name] += sign * d


@dataclass
class Captured:
    graph: "torch.cuda.CUDAGraph"
    out: object               # the body's return value: static tensors
    delta: list               # launch-counter moves of one replay
    capture_s: float          # warm-up + capture wall time

    def replay(self) -> None:
        global replays
        self.graph.replay()
        add_counters(self.delta)
        replays += 1


def capture(body: Callable[[], object], carried: Sequence[torch.Tensor],
            device: torch.device, pool=None) -> Captured:
    """Capture ``body`` as a CUDA graph: one eager warm-up on a side
    stream (lazy library state, attribute and occupancy queries are paid
    there), the ``carried`` tensors (the state the body rewrites) put
    back, then the capture into ``pool`` (a private pool when None). A
    failed capture raises; nothing falls back to eager launches."""
    t0 = time.perf_counter()
    saved: List[torch.Tensor] = [t.clone() for t in carried]
    main = torch.cuda.current_stream(device)
    side = _warmup_streams.get(device)
    if side is None:
        side = _warmup_streams[device] = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        body()
    main.wait_stream(side)
    for t, s in zip(carried, saved):
        t.copy_(s)
    before = counter_values()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
        out = body()
    after = counter_values()
    delta = [a - b for a, b in zip(after[:-1], before[:-1])]
    delta.append({k: after[-1][k] - before[-1][k] for k in after[-1]})
    add_counters(delta, -1)
    return Captured(graph, out, delta, time.perf_counter() - t0)


def pinned_copies(tensors: Sequence[Optional[torch.Tensor]], device):
    """Copy each device tensor into a fresh pinned host buffer on the
    current stream and record an event behind them: ``(buffers,
    event)``. The next replay cannot overwrite what the buffers hold."""
    out = []
    for t in tensors:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        out.append(buf)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return out, event
