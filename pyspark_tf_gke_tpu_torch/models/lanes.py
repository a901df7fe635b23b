"""Counter-based noise for the sampling lanes.

Every draw is a pure function of a lane's 32-bit seed key, its step
counter, a stream tag and a column index, hashed with a 32-bit integer
finalizer in int64 tensor arithmetic. No host RNG and no
``torch.Generator`` state is involved, so a captured CUDA graph replays
exactly the stream of eager launches, and each lane's draws depend only
on its own seed. The stream tags keep the uses of one step apart, as
the JAX engine folds a lane's threefry key with a different constant
for each use (``_fold_slot_keys(kd, 1)`` for a pick, ``3`` for a draft
proposal, ``4`` for the acceptance draws). Deterministic per seed, not
bit-equal to threefry.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF

# stream tags: the plain pick (the decode chunk's and a spec chunk's
# entry token), a draft proposal, the acceptance uniforms and the
# correction draw of the speculative rule
PICK, DRAFT, ACCEPT, CORRECT = 0, 3, 4, 5


def mul32(x, c: int):
    """``(x * c) mod 2**32`` for ``x`` in ``[0, 2**32)`` without leaving
    int64 (the constant is split in 16-bit halves); Python ints and int64
    tensors alike."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def mix32(x):
    """A 32-bit integer finalizer (xorshift-multiply): every input bit
    reaches every output bit."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    """A lane's 32-bit key from a request's (64-bit) seed."""
    s = int(seed) % (1 << 64)
    return mix32(mix32((s >> 32) ^ 0x9E3779B9) ^ (s & _M32))


def column_mix(n: int, device) -> torch.Tensor:
    """``[n]`` per-column words (a vocabulary index, a draft position)."""
    return mix32(torch.arange(n, dtype=torch.long, device=device)
                 + 0x2545F491)


def lane_bits(keys: torch.Tensor, draws: torch.Tensor, stream: int,
              cols: torch.Tensor) -> torch.Tensor:
    """``[B, n]`` 32-bit words: row ``b`` from ``keys[b]``, its step
    counter ``draws[b]`` and ``stream``; column ``j`` from ``cols[j]``."""
    tag = (stream * 0x9E3779B9) & _M32
    step = mix32((draws + 0x632BE5AB + tag) & _M32)
    row = mix32(keys ^ step)
    return mix32(row[:, None] ^ cols[None, :])


def uniforms(keys, draws, stream: int, cols) -> torch.Tensor:
    """``[B, n]`` f32 uniforms strictly inside (0, 1): 24 bits each."""
    bits = lane_bits(keys, draws, stream, cols)
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def gumbel(keys, draws, stream: int, cols) -> torch.Tensor:
    """``[B, n]`` Gumbel noise (``argmax(logits + noise)`` is a
    categorical draw)."""
    return -torch.log(-torch.log(uniforms(keys, draws, stream, cols)))
