"""Device resolution: the port runs where the caller asks, or raises.

There is no path that quietly carries on on the CPU: ``resolve_device``
returns the requested device only when it can deliver it, and a CUDA
device must be a Hopper card (compute capability 9.0, the ``sm_90a``
target the kernels in ``csrc/`` are built for).
"""

from __future__ import annotations

from typing import Union

import torch

REQUIRED_CAPABILITY = (9, 0)


def check_capability(device: torch.device) -> None:
    """Raise unless ``device`` is a CUDA card of compute capability 9.0."""
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{cap[0]}.{cap[1]}; the kernels are built for sm_90a "
            f"(capability {REQUIRED_CAPABILITY[0]}.{REQUIRED_CAPABILITY[1]})")


def resolve_device(name: Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:1", "cpu"). Raises
    when CUDA is asked for and there is no card, or the card is not
    compute capability 9.0."""
    device = torch.device(name)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {name!r} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) are visible")
    check_capability(device)
    return device
