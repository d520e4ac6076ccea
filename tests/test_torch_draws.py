"""The simulator's draws in the port against the JAX package's, compiled
(``jax.jit``), as its simulator runs them: every f32 uniform through
``exp_unit`` and through ``jax.random.normal``'s ``erf_inv`` path, the
lognormal, the think-gap and service samplers over every id, the MMPP
flip, the per-epoch draws and their host reconstruction, and the four
fault draws.  Each case asserts the level it reached: exact (bit for
bit), or, for the diurnal ramp's ``sin`` (XLA calls libm's ``sinf``), the
sine within 1 ulp and the rate within 16 ulps (an ulp of the sine is
many of ``1 + amp sin`` where that is near 0.1), each on at most 2 % of
draws.  The histogram's bucket index is in
``test_torch_hist_buckets.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.faults import model as rflt
from repro.workloads import generators as rg
from repro_torch.core import xla_math as xm
from repro_torch.faults import model as flt
from repro_torch.workloads import generators as tg

RNG = np.random.default_rng(21)
# Every f32 value jax.random.uniform returns: k * 2^-23, k < 2^23.
ALL_U = (np.arange(2**23, dtype=np.uint32) | 0x3F800000).view(
    np.float32) - np.float32(1.0)


def ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def assert_bits(got, want):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.dtype == want.dtype
    d = ulps(got, want)
    assert not d.any(), f"{int((d > 0).sum())} differ, max {d.max()} ulp"


def t(x):
    return torch.from_numpy(np.array(x))


def test_exp_unit_every_uniform():
    want = jax.jit(rg.exp_unit)(ALL_U)
    assert_bits(tg.exp_unit(t(ALL_U)), want)


def test_normal_every_uniform():
    """``jax.random.normal``'s path from each uniform: max(lo, f * 2 +
    lo), then sqrt(2) erf_inv."""
    lo = np.nextafter(np.float32(-1), np.float32(0))

    def ref(f):
        u = lax.max(lo, f * (np.float32(1.0) - lo) + lo)
        return np.float32(np.sqrt(2)) * lax.erf_inv(u)

    assert_bits(tg.normal_of_uniform(t(ALL_U)), jax.jit(ref)(ALL_U))


def test_log_log2_exp():
    """XLA's f32 ``log``, ``log2`` and ``exp`` on their own (the
    samplers fuse them into their neighbours: the cases above and the
    sweeps hold those), where the results are normal: XLA's CPU code
    flushes subnormal results to zero (exp below -87.34), the port and
    the kernel do not, and no draw of the simulator comes near it."""
    x = np.exp(RNG.normal(0.0, 8.0, 2**20)).astype(np.float32)
    assert_bits(xm.log(t(x)), jax.jit(jnp.log)(x))
    assert_bits(xm.log2(t(x)), jax.jit(jnp.log2)(x))
    y = RNG.uniform(-87.3, 88.7, 2**20).astype(np.float32)
    assert_bits(xm.exp(t(y)), jax.jit(jnp.exp)(y))


def test_counter_draws_match_jax_random():
    keys = [(s, st) for s in (0, 3, 2**31 - 1) for st in (
        tg.STREAM_THINK, tg.STREAM_SERVICE ^ 0x40000, tg.STREAM_SPIKE)]
    for seed, stream in keys:
        k = rg.stream_key(seed, stream)
        ix = RNG.integers(0, 2**20, size=(64, 2))
        want_u = jax.vmap(lambda a, b: rg.counter_uniform(k, a, b))(
            ix[:, 0], ix[:, 1])
        want_z = jax.vmap(lambda a, b: rg.counter_normal(k, a, b))(
            ix[:, 0], ix[:, 1])
        tk = tg.stream_key(seed, stream)
        assert_bits(tg.counter_uniform(tk, t(ix[:, 0]), t(ix[:, 1])), want_u)
        assert_bits(tg.counter_normal(tk, t(ix[:, 0]), t(ix[:, 1])), want_z)


@pytest.mark.parametrize("cv", [0.5, 1.0, 2.0])
def test_lognormal_unit(cv):
    """Compiled (the product fused into the subtraction) and op by op
    (the reference's eager host draws)."""
    key = rg.stream_key(7, 1)
    z = np.asarray(jax.jit(jax.vmap(lambda i: rg.counter_normal(key, i)))(
        np.arange(2**20, dtype=np.int32)))
    cv32 = np.float32(cv)
    assert_bits(tg.lognormal_unit(t(z), torch.tensor(cv32)),
                jax.jit(rg.lognormal_unit)(z, cv32))
    assert_bits(tg.lognormal_unit(t(z), cv, fused=False),
                rg.lognormal_unit(z, cv))


def _params(n, rng):
    """Per-draw traced parameters, as sweep cells carry them."""
    return dict(
        rate=rng.choice(np.float32([0.05, 0.31, 1.0, 2.7, 19.5]), n),
        burst=rng.choice(np.float32([1.0, 4.0, 9.5]), n),
        amp=rng.choice(np.float32([0.0, 0.5, 0.9]), n),
        p01=rng.random(n).astype(np.float32),
        on=rng.integers(0, 2, n).astype(np.int32),
        cv=rng.choice(np.float32([0.25, 1.0, 3.0]), n),
        mix=rng.choice(np.float32([0.0, 0.1, 0.5]), n),
        mix_scale=rng.choice(np.float32([1.5, 10.0, 40.0]), n))


@pytest.mark.parametrize("process", list(rg.ARRIVALS))
def test_think_gap(process):
    n, rng = 2**16, np.random.default_rng(22)
    u = rng.choice(ALL_U, n)
    p = _params(n, rng)
    pid = np.full(n, rg.ARRIVALS[process], np.int32)     # traced, as in
    want = jax.jit(rg.think_gap)(u, pid, p["rate"], p["on"],  # a sweep
                                 p["burst"], p["p01"], p["amp"])
    got = tg.think_gap(t(u), t(pid), t(p["rate"]), t(p["on"]),
                       t(p["burst"]), t(p["p01"]), t(p["amp"]))
    if process != "diurnal":
        assert_bits(got, want)
    else:
        # Level 3: the sine is libm's sinf on the reference side.
        d = ulps(got, want)
        assert d.max() <= 16 and (d > 0).mean() <= 0.02


@pytest.mark.parametrize("service", list(rg.SERVICES))
def test_service_unit(service):
    n, rng = 2**16, np.random.default_rng(23)
    u = rng.choice(ALL_U, n)
    z = np.asarray(tg.normal_of_uniform(t(rng.choice(ALL_U, n))))
    p = _params(n, rng)
    sid = np.full(n, rg.SERVICES[service], np.int32)
    want = jax.jit(rg.service_unit)(u, z, sid, p["cv"], p["mix"],
                                    p["mix_scale"])
    got = tg.service_unit(t(u), t(z), t(sid), t(p["cv"]),
                          t(p["mix"]), t(p["mix_scale"]))
    assert_bits(got, want)


def test_phase_flip_and_diurnal_rate():
    n, rng = 2**18, np.random.default_rng(24)
    u = rng.choice(ALL_U, n)
    on = rng.integers(0, 2, n).astype(np.int32)
    bl = rng.choice(np.float32([0.0, 1.0, 3.0, 8.0, 64.5]), n)
    np.testing.assert_array_equal(
        tg.phase_flip(t(u), t(on), t(bl)).numpy(),
        np.asarray(jax.jit(rg.phase_flip)(u, on, bl)))
    p = _params(n, rng)
    want = jax.jit(rg.diurnal_rate)(p["rate"], p["amp"], p["p01"])
    got = tg.diurnal_rate(t(p["rate"]), t(p["amp"]), t(p["p01"]))
    d = ulps(got, want)
    assert d.max() <= 16 and (d > 0).mean() <= 0.02
    # The sine alone, over [0, 1): about 1 % differ, by 1 ulp.
    ph = ALL_U[::8]
    d = ulps(xm.sin(xm.TWO_PI * t(ph)),
             jax.jit(lambda p: jnp.sin(2.0 * jnp.pi * p))(ph))
    assert d.max() <= 1 and (d > 0).mean() <= 0.02


def test_epoch_draws_over_a_grid():
    seeds, cores, epochs = (0, 3, 77), np.arange(8), np.arange(0, 4000, 37)
    for seed in seeds:
        c, e = np.meshgrid(cores, epochs, indexing="ij")
        c32, e32 = c.ravel().astype(np.int32), e.ravel().astype(np.int32)
        want_t = jax.vmap(lambda a, b: rg.epoch_think_u(seed, a, b))(c32, e32)
        want_u, want_z = jax.vmap(lambda a, b: rg.epoch_service_uz(
            seed, a, b))(c32, e32)
        want_p = jax.vmap(lambda a, b: rg.epoch_phase_u(seed, a, b))(c32, e32)
        tc, te = t(c32), t(e32)
        assert_bits(tg.epoch_think_u(seed, tc, te), want_t)
        got_u, got_z = tg.epoch_service_uz(seed, tc, te)
        assert_bits(got_u, want_u)
        assert_bits(got_z, want_z)
        assert_bits(tg.epoch_phase_u(seed, tc, te), want_p)


def test_normal_block():
    for seed, stream, n in ((0, tg.STREAM_SERVICE ^ 0x40000, 1000),
                            (5, 0x1234, 77), (2**31 - 1, 3, 4096)):
        got = tg.normal_block(seed, stream, n)
        want = rg.normal_block(seed, stream, n)
        assert got.dtype == want.dtype == np.float64
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("process,service", [
    ("poisson", "lognormal"), ("closed", "exp"), ("mmpp", "bimodal"),
    ("poisson", ("det", "exp", "lognormal", "bimodal") * 2)])
def test_epoch_scale_tables(process, service):
    kw = dict(process=process, rate=0.7, cv=1.5, mix=0.2, mix_scale=12.0,
              burstiness=3.0, burst_len=5.0, service=service)
    got = tg.epoch_scale_tables(11, 8, 300, **kw)
    want = rg.epoch_scale_tables(11, 8, 300, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        assert g.tobytes() == w.tobytes()


@functools.lru_cache(maxsize=None)
def _fault_refs():
    return dict(
        preempt=jax.jit(jax.vmap(rflt.preempt_extra)),
        straggle=jax.jit(jax.vmap(rflt.straggle_extra)),
        churn=jax.jit(jax.vmap(rflt.churn_off)),
        rejoin=jax.jit(jax.vmap(rflt.churn_rejoin)))


def test_fault_draws():
    n, n_cores = 4096, 8
    seed = RNG.integers(0, 2**31, n).astype(np.int32)
    core = RNG.integers(0, n_cores, n).astype(np.int32)
    ix = RNG.integers(0, 2**20, n).astype(np.int32)
    rate = RNG.choice(np.float32([0.0, 0.05, 0.5, 1.0]), n)
    scale = RNG.choice(np.float32([100.0, 5000.0, 31337.0]), n)
    dur = RNG.integers(1, 40_000, n).astype(np.int32)
    sscale = RNG.choice(np.float32([1.0, 2.5, 10.0]), n)
    tick = RNG.integers(0, 10**8, n).astype(np.int32)
    period = RNG.choice(np.int32([1, 500, 50_000]), n)
    ref = _fault_refs()
    ts, tc = t(seed), t(core)
    np.testing.assert_array_equal(
        flt.preempt_extra(ts, tc, t(ix), t(rate), t(scale), n_cores).numpy(),
        np.asarray(ref["preempt"](seed, core, ix, rate, scale)))
    np.testing.assert_array_equal(
        flt.straggle_extra(ts, tc, t(ix), t(dur), t(rate), t(sscale),
                           n_cores).numpy(),
        np.asarray(ref["straggle"](seed, core, ix, dur, rate, sscale)))
    np.testing.assert_array_equal(
        flt.churn_off(ts, tc, t(tick), t(rate), t(period), n_cores).numpy(),
        np.asarray(ref["churn"](seed, core, tick, rate, period)))
    np.testing.assert_array_equal(
        flt.churn_rejoin(t(tick), t(period)).numpy(),
        np.asarray(ref["rejoin"](tick, period)))
