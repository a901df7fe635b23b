"""Multi-process bootstrap on ``torch.distributed`` (counterpart of
``pyspark_tf_gke_tpu/parallel/distributed.py``).

The JAX package dials one coordinator through ``jax.distributed``; the
port dials the same address as the ``tcp://`` rendezvous of
``torch.distributed.init_process_group``: NCCL for ``cuda``, gloo for
``cpu``. The addressing conventions carry over unchanged: the k8s
headless-service name ``<job>-0.<job>-headless:<port>`` of process 0,
the ordinal parsed from ``$HOSTNAME``, strict IPv4 checks on an explicit
address.

One difference in meaning: a JAX process is a host and drives every chip
on it, while a port process drives ONE card. So ``--num-processes``
counts cards in the port (a node with 8 cards runs 8 processes), and a
process takes the card ``process_id % cards on the node``.
"""

from __future__ import annotations

import os
import re
import socket
from typing import Optional

import torch
import torch.distributed as dist

from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("parallel.distributed")

_ORDINAL_RE = re.compile(r"-(\d+)$")

DEFAULT_JOB_NAME = "tpu-worker"
DEFAULT_PORT = 8476


def process_ordinal_from_hostname(hostname: Optional[str] = None) -> Optional[int]:
    """StatefulSet ordinal from a pod hostname like ``tpu-worker-3``."""
    if hostname is None:
        hostname = os.environ.get("HOSTNAME", socket.gethostname())
    m = _ORDINAL_RE.search(hostname.strip())
    return int(m.group(1)) if m else None


def validate_ipv4(addr: str, what: str = "coordinator_addr") -> None:
    """Reject IPv6 / bracketed / scheme-prefixed addresses."""
    if any(sym in addr for sym in ("/", "[", "]", " ")):
        raise RuntimeError(f"{what} {addr!r} is malformed; provide a raw IPv4 or DNS name.")
    host = addr.rsplit(":", 1)[0] if addr.count(":") == 1 else addr
    if ":" in host and "." not in host:
        raise RuntimeError(
            f"{what} appears to be IPv6 ({addr!r}); provide a routable IPv4 address."
        )
    parts = host.split(".")
    if len(parts) == 4 and all(p.isdigit() for p in parts):
        if any(not 0 <= int(p) <= 255 for p in parts):
            raise RuntimeError(f"{what} {addr!r} is not a valid IPv4 address.")


def build_coordinator_address(
    coordinator_addr: str = "",
    port: int = DEFAULT_PORT,
    job_name: str = DEFAULT_JOB_NAME,
) -> str:
    """The address every process dials: the explicit one, else process
    0's headless-service name."""
    if coordinator_addr:
        validate_ipv4(coordinator_addr)
        return coordinator_addr if ":" in coordinator_addr else f"{coordinator_addr}:{port}"
    return f"{job_name}-0.{job_name}-headless:{port}"


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(
    num_processes: int = 1,
    process_id: int = -1,
    coordinator_addr: str = "",
    coordinator_port: int = DEFAULT_PORT,
    job_name: str = DEFAULT_JOB_NAME,
    device="cuda",
) -> None:
    """Join the world of ``num_processes`` ranks; a no-op for one.
    ``process_id=-1`` takes the pod hostname's ordinal. On ``cuda`` the
    process binds the card ``process_id % device_count`` first. A
    process already in a world of ``num_processes`` keeps it."""
    if num_processes <= 1:
        logger.info("Single-process run; skipping torch.distributed initialization.")
        return
    if dist.is_initialized():  # a restart, or a caller that joined first
        if dist.get_world_size() != num_processes:
            raise RuntimeError(
                f"already in a world of {dist.get_world_size()} ranks, "
                f"asked for {num_processes}")
        return
    if process_id < 0:
        ordinal = process_ordinal_from_hostname()
        if ordinal is None:
            raise RuntimeError(
                "process_id not given and hostname has no trailing ordinal; "
                "set --process-id or run in a StatefulSet/JobSet pod."
            )
        process_id = ordinal
    address = build_coordinator_address(coordinator_addr, coordinator_port, job_name)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    logger.info(
        "init_process_group(%s, tcp://%s, world_size=%d, rank=%d)",
        backend_for(device), address, num_processes, process_id,
    )
    dist.init_process_group(backend_for(device),
                            init_method=f"tcp://{address}",
                            world_size=num_processes, rank=process_id)


def ensure_world(device) -> None:
    """A world of one rank (an in-memory store) when no process group
    exists: a mesh on one process needs one, as a JAX mesh of one device
    needs no coordinator."""
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device), store=dist.HashStore(),
                                world_size=1, rank=0)


def as_host_array(x):
    """The whole of ``x`` on every rank: a DTensor is gathered to its
    full tensor (a collective, so every rank calls it); anything else is
    returned as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.full_tensor()
    return x
