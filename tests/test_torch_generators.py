"""The port's counter-based RNG against ``jax.random`` (threefry2x32,
``jax_threefry_partitionable=True``): keys, fold_in, split and uniform
must give the very same bits.  Inputs come from a seeded numpy generator;
tolerance: exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.workloads import generators as ref_gen
from repro_torch.workloads import generators as gen

RNG = np.random.default_rng(20260)
SPECIAL_SEEDS = [0, 1, 3, 7, -1, -7, 2**31 - 1, -2**31, 2**32 - 1,
                 2**40 + 5, -2**40, 123456789]
I32_SEEDS = RNG.integers(-2**31, 2**31, size=64, dtype=np.int64)


def _np(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SPECIAL_SEEDS)
def test_prngkey_special_seeds(seed):
    np.testing.assert_array_equal(gen.PRNGKey(seed).numpy(),
                                  _np(jax.random.PRNGKey(seed)))


def test_prngkey_batched_int32_seeds():
    """A tensor of seeds gives one key per seed, as the sweep builds
    them from ``SimParams.seed``."""
    want = np.stack([_np(jax.random.PRNGKey(np.int32(s)))
                     for s in I32_SEEDS])
    got = gen.PRNGKey(torch.from_numpy(I32_SEEDS.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("data", [0, 1, 0x7781, 0x778B, 2**31, 2**32 - 1])
def test_fold_in(data):
    for seed in SPECIAL_SEEDS:
        np.testing.assert_array_equal(
            gen.fold_in(gen.PRNGKey(seed), data).numpy(),
            _np(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


def test_fold_in_tensor_data_and_chains():
    """Traced-style data (int32, negatives wrap) and fold_in chains."""
    data = RNG.integers(-2**31, 2**31, size=16, dtype=np.int64)
    k_ref, k = jax.random.PRNGKey(11), gen.PRNGKey(11)
    for d in data:
        k_ref = jax.random.fold_in(k_ref, jnp.int32(d))
        k = gen.fold_in(k, torch.tensor(int(d), dtype=torch.int32))
        np.testing.assert_array_equal(k.numpy(), _np(k_ref))


def test_fold_in_rejects_out_of_range_python_ints():
    with pytest.raises(OverflowError):
        gen.fold_in(gen.PRNGKey(0), -3)
    with pytest.raises(OverflowError):
        gen.fold_in(gen.PRNGKey(0), 2**32)


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split(num):
    for seed in SPECIAL_SEEDS + I32_SEEDS[:8].tolist():
        np.testing.assert_array_equal(
            gen.split(gen.PRNGKey(seed), num).numpy(),
            _np(jax.random.split(jax.random.PRNGKey(seed), num)))


def test_split_chain_and_uniform_like_the_simulator():
    """The simulator's draw: split the key on every release, take
    ``uniform`` of the subkey.  200 steps from several seeds, batched."""
    seeds = I32_SEEDS[:8].astype(np.int32)
    k = gen.PRNGKey(torch.from_numpy(seeds))
    k_ref = [jax.random.PRNGKey(s) for s in seeds]
    for _ in range(200):
        ks = gen.split(k)
        k, sub = ks[:, 0], ks[:, 1]
        u = gen.uniform(sub).numpy()
        for i in range(len(seeds)):
            k_ref[i], sub_ref = jax.random.split(k_ref[i])
            assert u[i].tobytes() == \
                np.asarray(jax.random.uniform(sub_ref)).tobytes()
    np.testing.assert_array_equal(k.numpy(), np.stack([_np(x)
                                                       for x in k_ref]))


def test_uniform_many_keys():
    """uniform over 512 keys with random words (vmapped on the jax side)."""
    words = RNG.integers(0, 2**32, size=(512, 2), dtype=np.int64)
    want = np.asarray(jax.vmap(jax.random.uniform)(
        jnp.asarray(words.astype(np.uint32))))
    got = gen.uniform(torch.from_numpy(words)).numpy()
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert (got >= 0).all() and (got < 1).all()


def test_constants_match_reference():
    """Ids and stream constants keep the reference's values."""
    assert gen.ARRIVALS == ref_gen.ARRIVALS
    assert gen.SERVICES == ref_gen.SERVICES
    names = [n for n in dir(ref_gen) if n.startswith("STREAM_")]
    assert names
    for n in names:
        assert getattr(gen, n) == getattr(ref_gen, n), n
