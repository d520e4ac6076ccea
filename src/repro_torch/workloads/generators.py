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

The host blocks below (``uniform_block``, ``arrival_times``,
``service_times``, ``choice``) are the serving sims' and the trace
recorder's draws: element ``i`` of a stream is a pure function of
``(seed, stream, i)``, exactly as in the reference.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
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


# --------------------------------------------------------------------------
# Counter-based streams and host blocks (the serving sims / trace recorder)
# --------------------------------------------------------------------------

def stream_key(seed, stream: int) -> torch.Tensor:
    """Base key of one draw stream: ``fold_in(PRNGKey(seed), stream)``."""
    return fold_in(PRNGKey(seed), stream)


def counter_key(key: torch.Tensor, *indices) -> torch.Tensor:
    """Fold indices into a stream key (a pure counter, no state)."""
    for ix in indices:
        key = fold_in(key, ix)
    return key


def _pad_pow2(n: int) -> int:
    return 1 << max(6, int(n - 1).bit_length())


def _uniform_of(key: torch.Tensor, n: int) -> np.ndarray:
    """``uniform(fold_in(key, i))`` for ``i < n``, as f32 numpy."""
    ix = torch.arange(_pad_pow2(n), dtype=torch.int64)
    return uniform(fold_in(key, ix)).numpy()[:n]


def uniform_block(seed, stream: int, n: int) -> np.ndarray:
    """Host-side block of counter-based uniforms: element ``i`` is
    ``uniform(fold_in(stream_key(seed, stream), i))``, independent of
    ``n``, bit-identical to the reference's block (as f64)."""
    return _uniform_of(stream_key(seed, stream), n).astype(np.float64)


def exp_unit(u: torch.Tensor) -> torch.Tensor:
    """Exp(1) from a uniform (inverse CDF), in the uniform's dtype."""
    return -torch.log1p(-u)


def mmpp_rates(rate, burstiness):
    """On/off rates of the 2-state MMPP with long-run mean ``rate`` (the
    harmonic mean of the two, phase residence counted in draws)."""
    r_off = rate * (1.0 + burstiness) / (2.0 * burstiness)
    return burstiness * r_off, r_off


def phase_bits(seed, n, burst_len, *, core=None, stream=STREAM_PHASE):
    """The MMPP phase sequence for draws ``0..n-1``: a cumulative XOR of
    counter-based flips (``core`` namespaces per-client streams)."""
    if n == 0:
        return np.zeros(0, np.int32)
    key = stream_key(seed, stream)
    if core is not None:
        key = counter_key(key, core)
    u = _uniform_of(key, n)
    init_on = (u[0] < 0.5).astype(np.int32)
    flips = (u < 1.0 / max(float(burst_len), 1.0)).astype(np.int32)
    flips[0] = 0                       # draw 0 sets the initial phase
    return (init_on + np.cumsum(flips)) % 2


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """An arrival process in host units (events per second)."""

    process: str = "poisson"
    rate: float = 1.0             # mean arrivals/sec
    burstiness: float = 1.0       # MMPP on/off rate ratio (1 = plain)
    burst_len: float = 8.0        # mean draws per MMPP phase
    amp: float = 0.0              # diurnal amplitude in [0,1)
    period: float = 0.0           # diurnal period (sec); 0 = flat

    def __post_init__(self):
        if self.process not in ARRIVALS:
            raise ValueError(f"unknown arrival process {self.process!r}; "
                             f"one of {sorted(ARRIVALS)}")


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    """A service-time distribution in host units (seconds)."""

    dist: str = "det"
    mean: float = 1.0
    cv: float = 1.0               # lognormal coefficient of variation
    mix: float = 0.0              # bimodal: P(long mode)
    mix_scale: float = 10.0       # bimodal: long/short ratio

    def __post_init__(self):
        if self.dist not in SERVICES:
            raise ValueError(f"unknown service dist {self.dist!r}; "
                             f"one of {sorted(SERVICES)}")


def arrival_times(spec: ArrivalSpec, duration: float, seed: int,
                  *, stream: int = STREAM_THINK) -> np.ndarray:
    """Arrival times in [0, duration), deterministic per (spec, seed): gap
    ``i`` uses counter draw ``i`` of ``stream``; the gaps are f64 numpy
    math on the f32 uniforms, as in the reference, so the times are
    bit-identical to it."""
    r_on, _ = mmpp_rates(spec.rate, spec.burstiness)
    r_max = max(spec.rate * (1.0 + abs(spec.amp)), float(r_on), 1e-9)
    n = int(duration * r_max * 1.4) + 64
    u = uniform_block(seed, stream, n)
    e1 = -np.log1p(-u)
    if spec.process == "closed":
        gaps = np.full(n, 1.0 / spec.rate)
    elif spec.process == "poisson":
        gaps = e1 / spec.rate
    elif spec.process == "mmpp":
        on = phase_bits(seed, n, spec.burst_len, stream=stream ^ 0x10000)
        r_on, r_off = mmpp_rates(spec.rate, spec.burstiness)
        gaps = e1 / np.where(on == 1, r_on, r_off)
    else:  # diurnal: the rate seen by gap i follows the running clock
        period = spec.period if spec.period > 0 else duration
        gaps = np.empty(n)
        t = 0.0
        for i in range(n):
            mod = 1.0 + spec.amp * math.sin(
                2.0 * math.pi * ((t / period) % 1.0))
            r = max(spec.rate * mod, 0.05 * spec.rate)
            gaps[i] = e1[i] / r
            t += gaps[i]
    t = np.cumsum(gaps)
    return t[t < duration]


def service_times(spec: ServiceSpec, n: int, seed: int,
                  *, stream: int = STREAM_SERVICE) -> np.ndarray:
    """``n`` service times (mean ``spec.mean``), counter-based per index,
    in f32 as the reference computes them.  ``det`` and ``bimodal`` are
    bit-identical to it; ``exp`` passes through f32 ``log1p`` and agrees
    within a few ulps.  ``lognormal`` needs the normal draws, which are
    not ported yet."""
    if spec.dist == "lognormal":
        raise NotImplementedError(
            "lognormal service times need counter-based normal draws, "
            "which are not ported to repro_torch yet")
    u = uniform_block(seed, stream, n).astype(np.float32)
    if spec.dist == "det":
        unit = np.ones(n, np.float32)
    elif spec.dist == "exp":
        unit = exp_unit(torch.from_numpy(u)).numpy()
    else:  # bimodal
        short = 1.0 / ((1.0 - spec.mix) + spec.mix * spec.mix_scale)
        unit = np.where(u < np.float32(spec.mix),
                        np.float32(short * spec.mix_scale),
                        np.float32(short))
    return spec.mean * unit


def client_think_gaps(seed, client: int, n: int,
                      *, stream: int = STREAM_THINK) -> np.ndarray:
    """Exp(1) think gaps for one closed-loop client, counter-based per
    (client, request index); scale by the mean think time at the call."""
    u = _uniform_of(counter_key(stream_key(seed, stream), client), n)
    return -np.log1p(-u.astype(np.float64))


def straggle_uniforms(seed, replica: int, n: int,
                      *, stream: int = STREAM_STRAGGLE) -> np.ndarray:
    """Straggler-decision uniforms for one replica/pod: element ``i`` is
    pure in ``(seed, replica, i)`` (the draw for step ``i`` is the same
    whatever the horizon, the pod count or the commit interleaving),
    bit-identical to the reference's (as f64)."""
    return _uniform_of(counter_key(stream_key(seed, stream), replica),
                       n).astype(np.float64)


def choice(values, n: int, seed: int, *, stream: int = STREAM_COLS,
           weights=None) -> np.ndarray:
    """Counter-based categorical draw over ``values`` (uniform unless
    ``weights``)."""
    values = np.atleast_1d(np.asarray(values))
    u = uniform_block(seed, stream, n)
    if weights is None:
        idx = np.minimum((u * len(values)).astype(np.int64),
                         len(values) - 1)
    else:
        w = np.asarray(weights, np.float64)
        cum = np.cumsum(w / w.sum())
        idx = np.searchsorted(cum, u, side="right")
        idx = np.minimum(idx, len(values) - 1)
    return values[idx]
