"""Counter-based RNG of the simulator: threefry2x32 with jax's default key
semantics, on PyTorch tensors.

The simulator's random draws (the ``tas`` / ``libasl`` standby picks, and
later the workload streams) are pure functions of a two-word key, so the
port has to produce the very same bits as ``jax.random`` under jax's
default ``jax_threefry_partitionable=True``:

* ``PRNGKey(seed)`` is ``[0, seed mod 2**32]``;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
* ``split(key, n)[i]`` is ``threefry2x32(key, (0, i))``;
* ``uniform(key)`` takes ``bits = y0 ^ y1`` of ``threefry2x32(key, (0, 0))``
  and builds the float as ``((bits >> 9) | 0x3F800000)`` reinterpreted as
  f32, minus 1.0.

A key is an int64 tensor of shape ``[..., 2]`` holding two unsigned 32-bit
words.  PyTorch on the CPU has no ``+``, ``<<`` or ``>>`` on ``uint32``, so
the rounds run in int64 and mask with ``0xFFFFFFFF`` after every add and
shift.  The same function also takes plain Python ints (as the CUDA kernel's
host-side checks do).
"""

from __future__ import annotations

import torch

# Arrival processes and service-time distributions: the reference's ids, so
# a config written for the JAX package names the same ones.
ARRIVALS = {"closed": 0, "poisson": 1, "mmpp": 2, "diurnal": 3}
SERVICES = {"det": 0, "exp": 1, "lognormal": 2, "bimodal": 3}

# Independent draw streams (fold_in'd into the seed); the reference's values.
STREAM_THINK = 0x7781
STREAM_SERVICE = 0x7782
STREAM_PHASE = 0x7783
STREAM_CLASS = 0x7784
STREAM_COLS = 0x7785
STREAM_STRAGGLE = 0x7786
STREAM_PREEMPT = 0x7787
STREAM_CHURN = 0x7788
STREAM_SPIKE = 0x7789
STREAM_KEY = 0x778A
STREAM_RW = 0x778B

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block on 32-bit words held in int64
    tensors (or Python ints).  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _u32(x, what: str):
    """An integer (tensor) as the unsigned 32-bit word jax would see."""
    if isinstance(x, torch.Tensor):
        if x.dtype.is_floating_point or x.dtype == torch.bool:
            raise TypeError(f"{what} must be an integer tensor, got {x.dtype}")
        return x.to(torch.int64) & M32
    return int(x) & M32


def PRNGKey(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey``: ``[0, seed mod 2**32]`` as int64 ``[..., 2]``
    (a tensor of seeds gives one key per element)."""
    s = torch.as_tensor(_u32(seed, "seed"), dtype=torch.int64, device=device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def _block(key: torch.Tensor, hi, lo):
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], hi, lo)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``.  ``data`` is taken as an unsigned 32-bit
    word; a Python int outside ``[0, 2**32)`` raises, as it does in jax."""
    if not isinstance(data, torch.Tensor) and not 0 <= int(data) <= M32:
        raise OverflowError(f"fold_in data {data} is out of bounds for uint32")
    return _block(key, 0, _u32(data, "data"))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., num, 2]`` subkeys."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    return _block(key[..., None, :], 0, counts)


def random_bits(key: torch.Tensor) -> torch.Tensor:
    """One 32-bit draw per key (jax's partitionable ``_random_bits`` at
    shape ``()``): ``y0 ^ y1`` of the block at counter 0."""
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, 0)
    return y0 ^ y1


def uniform(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key)``: one f32 in ``[0, 1)`` per key."""
    mant = (random_bits(key) >> 9) | 0x3F800000
    f = mant.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f, 0.0)
