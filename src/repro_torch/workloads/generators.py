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

from repro_torch.core import xla_math as xm

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


def counter_uniform(key: torch.Tensor, *indices) -> torch.Tensor:
    """U[0, 1) as a pure function of (stream key, indices)."""
    return uniform(counter_key(key, *indices))


#: The lower end of ``jax.random.normal``'s uniform: nextafter(-1, 0) in f32.
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal_of_uniform(f: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal``'s value from its uniform draw ``f`` in [0, 1):
    ``u = max(lo, f * (1 - lo) + lo)`` (the f32 ``1 - lo`` is 2.0, so the
    product is exact), then ``sqrt(2) * erf_inv(u)``."""
    u = torch.clamp_min(f.to(torch.float32) * 2.0 + NORMAL_LO, NORMAL_LO)
    return xm.erf_inv(u) * xm.SQRT2


def counter_normal(key: torch.Tensor, *indices) -> torch.Tensor:
    """N(0, 1) as a pure function of (stream key, indices), as
    ``jax.random.normal`` draws it."""
    return normal_of_uniform(uniform(counter_key(key, *indices)))


def normal_block(seed, stream: int, n: int) -> np.ndarray:
    """Host block of counter-based normals (element ``i`` is
    ``counter_normal(stream_key(seed, stream), i)``, as f64)."""
    f = torch.from_numpy(_uniform_of(stream_key(seed, stream), n))
    return normal_of_uniform(f).numpy().astype(np.float64)


_CORE_KEYS: dict = {}


def core_keys(seed: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """``counter_key(stream_key(seed, stream), core)`` for every cell's seed
    (``[B]``) and core ``< n``: ``[B, n, 2]``, the keys a simulator draw
    folds its event index into.  Cached per seed tensor (a sweep draws
    from the same keys at every event)."""
    hit = _CORE_KEYS.get((id(seed), stream, n))
    if hit is not None and hit[0] is seed:
        return hit[1]
    cores = torch.arange(n, dtype=torch.int64, device=seed.device)
    keys = fold_in(stream_key(seed, stream)[:, None, :], cores[None, :])
    if len(_CORE_KEYS) > 64:
        _CORE_KEYS.clear()
    _CORE_KEYS[(id(seed), stream, n)] = (seed, keys)
    return keys


def event_uniform(seed, stream: int, c, ix, n: int) -> torch.Tensor:
    """One simulator draw per cell: ``counter_uniform(stream_key(seed,
    stream), c, ix)`` for ``[B]`` seeds, cores ``c`` and indices ``ix``
    (``n`` cores a cell)."""
    return event_uniforms(seed, (stream,), c, ix, n)[:, 0]


def event_uniforms(seed, streams: tuple, c, ix, n: int) -> torch.Tensor:
    """:func:`event_uniform` of several streams at one index, ``[B, K]``
    (one threefry pass for all of them)."""
    keys = torch.stack([core_keys(seed, st, n) for st in streams], dim=2)
    r = torch.arange(keys.shape[0], device=keys.device)
    return uniform(fold_in(keys[r, c.long()], ix[:, None]))


def exp_unit(u: torch.Tensor) -> torch.Tensor:
    """Exp(1) from an f32 uniform (inverse CDF): ``-log1p(-u)`` with XLA's
    f32 ``log1p``, so bit-identical to the reference."""
    return -xm.log1p(-u.to(torch.float32))


def lognormal_unit(z, cv, fused: bool = True) -> torch.Tensor:
    """Mean-1 lognormal with coefficient of variation ``cv`` from a
    standard normal ``z``: ``exp(sqrt(s2) z - s2 / 2)``, ``s2 =
    log1p(cv^2)``.  Compiled, XLA fuses the product into the subtraction
    (``fused``); the reference's eager host draws do not."""
    cv = torch.as_tensor(cv, dtype=torch.float32)
    s2 = xm.log1p(cv * cv)
    sd = xm.sqrt(s2)
    if fused:
        a = xm.fma(sd, z, -(0.5 * s2))
    else:
        a = sd * z - 0.5 * s2
    return xm.exp(a)


def bimodal_unit(u, mix, mix_scale, fused: bool = True) -> torch.Tensor:
    """Mean-1 two-point Get/Put mix: with probability ``mix`` the long
    mode (``mix_scale`` x the short one), else the short mode."""
    mix = torch.as_tensor(mix, dtype=torch.float32)
    mix_scale = torch.as_tensor(mix_scale, dtype=torch.float32)
    den = xm.fma(mix, mix_scale, 1.0 - mix) if fused else \
        (1.0 - mix) + mix * mix_scale
    short = 1.0 / den
    return torch.where(u < mix, short * mix_scale, short)


def _ids(x) -> set:
    """The ids a tensor of distribution / process ids may hold: those it
    holds on the CPU, every id on a card (where reading them would stall
    the stream)."""
    if not isinstance(x, torch.Tensor):
        return {int(x)}
    if x.device.type != "cpu":
        return set(range(4))
    return set(torch.unique(x).tolist())


def service_unit(u, z, dist, cv, mix, mix_scale) -> torch.Tensor:
    """Mean-1 service multiplier, branchless over the SERVICES id, as the
    compiled reference draws it (a sampler no element selects is
    skipped)."""
    ids = _ids(dist)
    out = torch.ones_like(u, dtype=torch.float32)
    if SERVICES["exp"] in ids:
        out = torch.where(dist == SERVICES["exp"], exp_unit(u), out)
    if SERVICES["lognormal"] in ids:
        out = torch.where(dist == SERVICES["lognormal"],
                          lognormal_unit(z, cv), out)
    if SERVICES["bimodal"] in ids:
        out = torch.where(dist == SERVICES["bimodal"],
                          bimodal_unit(u, mix, mix_scale), out)
    return out


def phase_flip(u, on, burst_len) -> torch.Tensor:
    """One MMPP phase step: flip with probability 1 / burst_len."""
    flip = u < 1.0 / torch.clamp_min(burst_len, 1.0)
    return torch.where(flip, 1 - on, on)


def diurnal_rate(rate, amp, phase01) -> torch.Tensor:
    """Sinusoidal rate ramp ``rate (1 + amp sin(2 pi phase01))``, floored
    at 5 % of the mean (the sine is :func:`xla_math.sin`: level 3)."""
    mod = xm.fma(amp, xm.sin(xm.TWO_PI * phase01), 1.0)
    return torch.maximum(rate * mod, np.float32(0.05) * rate)


def think_gap(u, process, rate, on, burstiness, phase01,
              amp) -> torch.Tensor:
    """One inter-arrival / think gap (mean 1 / rate), branchless over the
    ARRIVALS id, in f32 as the compiled reference draws it (a process no
    element selects is skipped)."""
    ids = _ids(process)
    gap = (1.0 / rate) * torch.ones_like(u)
    if ids == {ARRIVALS["closed"]}:
        return gap
    e1 = exp_unit(u)
    gap = torch.where(process == ARRIVALS["poisson"], e1 / rate, gap)
    if ARRIVALS["mmpp"] in ids:
        r_on, r_off = mmpp_rates(rate, burstiness)
        gap = torch.where(process == ARRIVALS["mmpp"],
                          e1 / torch.where(on == 1, r_on, r_off), gap)
    if ARRIVALS["diurnal"] in ids:
        gap = torch.where(process == ARRIVALS["diurnal"],
                          e1 / diurnal_rate(rate, amp, phase01), gap)
    return gap


def epoch_think_u(seed, core, epoch) -> torch.Tensor:
    return counter_uniform(stream_key(seed, STREAM_THINK), core, epoch)


def epoch_service_uz(seed, core, epoch) -> tuple:
    u = counter_uniform(stream_key(seed, STREAM_SERVICE), core, epoch)
    z = counter_normal(stream_key(seed, STREAM_SERVICE ^ 0x40000),
                       core, epoch)
    return u, z


def epoch_phase_u(seed, core, epoch) -> torch.Tensor:
    return counter_uniform(stream_key(seed, STREAM_PHASE), core, epoch)


def epoch_scale_tables(seed, n_cores: int, n_epochs: int, *, process,
                       rate, cv=1.0, mix=0.0, mix_scale=10.0,
                       burstiness=1.0, burst_len=8.0, service="det"):
    """Host reconstruction of the simulator's per-epoch workload draws:
    ``(think, svc)``, f64 ``[n_cores, n_epochs]``, as the reference's
    function computes them (its knobs are Python floats, so the mix and
    MMPP rates are f64 arithmetic and the samplers run op by op, with no
    fused multiply-add).  The diurnal ramp depends on simulated time and
    raises, as in the reference."""
    if process == "diurnal":
        raise ValueError("diurnal draws depend on simulated time; only "
                         "counter-pure processes can be reconstructed")
    pid = ARRIVALS[process]
    if isinstance(service, str):
        sid = np.full((n_cores, 1), SERVICES[service])
    else:
        if len(service) != n_cores:
            raise ValueError(f"per-core service list has {len(service)} "
                             f"entries for {n_cores} cores")
        sid = np.asarray([SERVICES[s] for s in service])[:, None]
    cores = torch.arange(n_cores, dtype=torch.int64)[:, None]
    epochs = torch.arange(n_epochs, dtype=torch.int64)[None, :]
    u_t = epoch_think_u(seed, cores, epochs)
    u_s, z_s = epoch_service_uz(seed, cores, epochs)
    on = np.stack([phase_bits(seed, n_epochs, burst_len, core=int(c))
                   for c in range(n_cores)]) if n_epochs else \
        np.zeros((n_cores, 0), np.int32)
    e1 = exp_unit(u_t)
    if pid == ARRIVALS["closed"]:
        think = torch.full_like(e1, np.float32(1.0 / rate))
    elif pid == ARRIVALS["poisson"]:
        think = e1 / np.float32(rate)
    else:
        r_on, r_off = mmpp_rates(rate, burstiness)
        think = e1 / torch.from_numpy(
            np.where(on == 1, r_on, r_off).astype(np.float32))
    sid = torch.from_numpy(np.broadcast_to(sid, u_s.shape).copy())
    svc = torch.ones_like(u_s)
    svc = torch.where(sid == SERVICES["exp"], exp_unit(u_s), svc)
    svc = torch.where(sid == SERVICES["lognormal"],
                      lognormal_unit(z_s, cv, fused=False), svc)
    short = 1.0 / ((1.0 - mix) + mix * mix_scale)
    svc = torch.where(sid == SERVICES["bimodal"],
                      torch.where(u_s < np.float32(mix),
                                  np.float32(short * mix_scale),
                                  np.float32(short)), svc)
    return (think.numpy().astype(np.float64),
            svc.numpy().astype(np.float64))


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


# Shape of the legacy ``rng.lognormal(log(m), 0.3)`` service draw of the
# fleet dispatcher: cv = sqrt(exp(0.09) - 1), and its *mean* was
# m * exp(0.045) (m was the median).  ServiceSpec is mean-parameterized,
# so the legacy calibration needs the inflation too.
LEGACY_LOGNORMAL_CV = float(np.sqrt(np.expm1(0.3 ** 2)))
LEGACY_LOGNORMAL_MEAN = float(np.exp(0.5 * 0.3 ** 2))


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
    in f32 as the reference computes them (its samplers op by op, the
    bimodal modes in f64 from Python floats): bit-identical to it."""
    u = torch.from_numpy(uniform_block(seed, stream, n).astype(np.float32))
    if spec.dist == "det":
        unit = torch.ones(n)
    elif spec.dist == "exp":
        unit = exp_unit(u)
    elif spec.dist == "lognormal":
        z = torch.from_numpy(normal_block(seed, stream ^ 0x40000, n)
                             .astype(np.float32))
        unit = lognormal_unit(z, spec.cv, fused=False)
    else:  # bimodal
        short = 1.0 / ((1.0 - spec.mix) + spec.mix * spec.mix_scale)
        unit = torch.where(u < np.float32(spec.mix),
                           np.float32(short * spec.mix_scale),
                           np.float32(short))
    return spec.mean * unit.numpy()


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
