"""The port's ``powf`` (``core/xla_math.py``: glibc's ``powf``, which XLA's
CPU code calls for an f32 ``x ** y``) against the JAX package's compiled
``**``: over every base the Zipf sampler's tail reaches (``fma(eta, u,
-eta) + 1`` for every one of the 2^23 f32 uniforms) under the keyshard
figure's five exponents at its 4,096 keys, over ``0.5 ** theta``, over
random bases and exponents and over the special cases; and ``fma64``, the
exact f64 fused multiply-add it is built on, against exact rational
arithmetic.  Tolerance: bit for bit (level 1).  The Zipf keys themselves
are in ``test_torch_keys_zipf.py``."""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from repro.workloads import keys as rk
from repro_torch.core import xla_math as xm

# Every f32 value jax.random.uniform returns: k * 2^-23, k < 2^23.
ALL_U = (np.arange(2**23, dtype=np.uint32) | 0x3F800000).view(
    np.float32) - np.float32(1.0)
THETAS = (0.0, 0.5, 0.9, 0.99, 1.2)      # paper_figs.KEYSHARD_THETAS
N_KEYS = 4096
POW = jax.jit(lambda x, y: x ** y)


def assert_bits(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    same = (got.view(np.int32) == want.view(np.int32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), f"{int((~same).sum())} differ"


@pytest.mark.parametrize("theta", THETAS)
def test_powf_every_tail_base(theta):
    """The tail's base for every uniform, raised to alpha = 1/(1-theta)."""
    _, _, eta, alpha = rk.zipf_consts(N_KEYS, theta)
    eta, alpha = np.float32(eta), np.float32(alpha)
    base = xm.fma(torch.from_numpy(ALL_U), float(eta), -float(eta)) + 1.0
    got = xm.powf(base, torch.tensor(alpha))
    assert_bits(got, POW(base.numpy(), alpha))


def test_powf_half_to_theta():
    """``0.5 ** theta`` (the sampler's rank-1 edge), over the figure's
    exponents and a sweep of others."""
    th = np.asarray([rk.zipf_consts(N_KEYS, t)[0] for t in THETAS]
                    + list(np.linspace(0.0, 3.0, 3001)), np.float32)
    half = np.full_like(th, 0.5)
    assert_bits(xm.powf(torch.from_numpy(half), torch.from_numpy(th)),
                POW(half, th))


def test_powf_random_bases_and_exponents():
    rng = np.random.default_rng(22)
    x = np.concatenate([rng.uniform(0, 8, 200_000),
                        np.exp(rng.uniform(-80, 80, 200_000))]).astype(
        np.float32)
    y = rng.uniform(-12, 12, x.size).astype(np.float32)
    assert_bits(xm.powf(torch.from_numpy(x), torch.from_numpy(y)),
                POW(x, y))


def test_powf_special_cases():
    """Zeros, infinities, NaN, 1, -1, negative bases with integer and
    non-integer exponents, overflow and underflow (to flushed zeros).  A
    subnormal base is left out: XLA's runtime reads it as zero
    (denormals-are-zero), glibc normalises it, and the port does as
    glibc."""
    xs = np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, -2.0,
                     -0.5, 2.0, 0.5, 3.0e38, 1.5e-38, 1.0e-10, 7.0],
                    np.float32)
    ys = np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 2.0,
                     3.0, -3.0, 0.5, -0.5, 2.5, 1e10, -1e10, 150.0, -150.0,
                     40.0, -40.0, 2.0**24 + 2, 7.0], np.float32)
    x, y = (a.ravel() for a in np.meshgrid(xs, ys))
    assert_bits(xm.powf(torch.from_numpy(x), torch.from_numpy(y)),
                POW(x, y))


def test_fma64_is_exact():
    """``a * b + c`` rounded once: against the exact sum, rounded to f64
    by Python (Fraction -> float rounds to nearest, ties to even)."""
    rng = np.random.default_rng(5)
    n = 20_000
    a = rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
    b = rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
    # c near -a*b makes the cancellation (and the low parts) matter.
    c = np.where(rng.random(n) < 0.5, -(a * b) * (1 + rng.standard_normal(n)
                                                  * 1e-9),
                 rng.standard_normal(n))
    got = xm.fma64(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(c)).numpy()
    want = np.asarray([float(Fraction(x) * Fraction(y) + Fraction(z))
                       for x, y, z in zip(a, b, c)])
    assert (got.view(np.int64) == want.view(np.int64)).all()
