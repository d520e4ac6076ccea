"""The port's Zipf key streams (``workloads/keys.py``) against the JAX
package's: ``zipf_key`` and the bucket index for every one of the 2^23 f32
uniforms under the keyshard figure's five exponents, compiled as the
simulator draws it (``eta u - eta`` one FMA); ``epoch_lock`` over a grid of
seeds, cores and epochs; the host tables ``key_table``, ``lock_table`` and
``rw_table`` (op by op, as the reference builds them) and ``zipf_pmf``;
and the keys' moments against the pmf.  Tolerance: exact equality
(level 1), the moments within their sampling error."""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.workloads import keys as rk
from repro_torch.workloads import keys as tk
from test_torch_keys import ALL_U, N_KEYS, THETAS


@functools.lru_cache(maxsize=None)
def port_keys(theta) -> np.ndarray:
    """The port's key for every uniform (shared by the tests below)."""
    th, ze, et, al = tk.zipf_consts(N_KEYS, theta)
    return tk.zipf_key(torch.from_numpy(ALL_U), N_KEYS, th, ze, et,
                       al).numpy()


@pytest.mark.parametrize("theta", THETAS)
def test_zipf_key_and_lock_every_uniform(theta):
    th, ze, et, al = rk.zipf_consts(N_KEYS, theta)
    want = np.asarray(jax.jit(rk.zipf_key)(ALL_U, N_KEYS, th, ze, et, al))
    got = port_keys(theta)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    for n_locks in (16, 3):
        lk = tk.key_to_lock(torch.from_numpy(got), n_locks).numpy()
        assert np.array_equal(lk, np.asarray(rk.key_to_lock(want, n_locks)))


def test_epoch_lock_matches_reference():
    """The engine's composition, compiled with its constants traced, as the
    simulator's params are: (seed, core, epoch) -> lock.  (Closed over as
    compile-time constants instead, XLA rewrites the tail's arithmetic and
    a few keys move.)"""
    seeds, cores, eps = (a.ravel() for a in np.meshgrid(
        np.arange(4, dtype=np.int32), np.arange(8, dtype=np.int32),
        np.arange(300, dtype=np.int32)))
    for theta, n_keys, n_locks in ((0.99, 4096, 16), (1.2, 64, 8),
                                   (0.0, 2, 1), (0.5, 1000, 7)):
        th, ze, et, al = rk.zipf_consts(n_keys, theta)
        args = (n_keys, np.float32(th), np.float32(ze), np.float32(et),
                np.float32(al), n_locks)
        want = np.asarray(jax.jit(jax.vmap(
            rk.epoch_lock, in_axes=(0, 0, 0) + (None,) * 6))(
            seeds, cores, eps, *args))
        got = tk.epoch_lock(torch.from_numpy(seeds), torch.from_numpy(cores),
                            torch.from_numpy(eps), *args).numpy()
        assert np.array_equal(got, want)
        u = tk.epoch_rw_u(torch.from_numpy(seeds), torch.from_numpy(cores),
                          torch.from_numpy(eps)).numpy()
        ru = np.asarray(jax.jit(jax.vmap(rk.epoch_rw_u))(seeds, cores, eps))
        assert u.tobytes() == ru.tobytes()


@pytest.mark.parametrize("args", [(3, 8, 200, 4096, 0.99),
                                  (0, 5, 64, 16, 1.2),
                                  (7, 8, 100, 2, 0.0),
                                  (1, 3, 50, 1, 0.5)])
def test_host_tables_match_reference(args):
    """The reference's host tables run op by op (no FMA): the port's
    ``fused=False`` path."""
    assert np.array_equal(tk.key_table(*args), rk.key_table(*args))
    assert np.array_equal(tk.lock_table(*args, 5), rk.lock_table(*args, 5))
    seed, n, e = args[:3]
    for wfrac in (0.0, 0.3, 0.5, 1.0):
        assert np.array_equal(tk.rw_table(seed, n, e, wfrac),
                              rk.rw_table(seed, n, e, wfrac))
    assert np.array_equal(tk.zipf_pmf(args[3], args[4]),
                          rk.zipf_pmf(args[3], args[4]))
    for n_keys, theta in ((4096, 1.0), (3, 2.0), (1, 0.0)):
        assert tk.zipf_consts(n_keys, theta) == rk.zipf_consts(n_keys, theta)


@pytest.mark.parametrize("theta", THETAS)
def test_key_moments_follow_pmf(theta):
    """Over all 2^23 uniforms (the exact distribution of the sampler's
    input), the key frequencies follow ``zipf_pmf`` as far as the YCSB
    inverse CDF does: ranks 0 and 1 exactly up to the uniform grid, the
    distribution within total variation 0.025 and the mean rank within 6 %
    (the power-law tail is an approximation: 0.021 and 5.6 % at theta
    1.2), the hot bucket's share of 16 locks within 0.005."""
    keys = port_keys(theta)
    pmf = tk.zipf_pmf(N_KEYS, theta)
    freq = np.bincount(keys, minlength=N_KEYS) / keys.size
    assert abs(freq[0] - pmf[0]) < 1e-6
    if theta > 0.0:
        assert abs(freq[1] - pmf[1]) < 1e-6
    ranks = np.arange(N_KEYS)
    assert 0.5 * np.abs(freq - pmf).sum() < 0.025
    assert abs(freq @ ranks - pmf @ ranks) <= 0.06 * (pmf @ ranks)
    hot = freq[ranks % 16 == 0].sum()
    assert abs(hot - pmf[ranks % 16 == 0].sum()) < 0.005
    assert keys.min() >= 0 and keys.max() < N_KEYS
