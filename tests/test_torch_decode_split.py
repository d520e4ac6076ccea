"""The decode kernel's split-and-merge arithmetic, in its plain PyTorch
form (``kernels/ref.py::decode_attention_split_ref``: partials over each
split's run positions, then the merge in split order), against the
port's plain ``decode_attention_ref`` and the JAX package's Pallas
``decode_attention`` in interpret mode (as ``tests/test_kernels.py``
runs it); and the split planner, which sees shapes only.

Inputs are made with numpy from a seed; bf16 inputs are the same bits on
both sides.  Tolerance: ``tests/test_kernels.py``'s ``TOL`` (f32 3e-5,
bf16 2e-2, absolute and relative), as ``tests/test_torch_attention.py``;
a row of length 0 must come out exactly 0 (the oracles give NaN
there)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ref

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, h, kh, t, dh, dtype, seed):
    """(JAX arrays, torch tensors) of standard normals in ``dtype``."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((b, h, dh), (b, kh, t, dh), (b, kh, t, dh))]
    return ([jnp.asarray(x).astype(JDT[dtype]) for x in xs],
            [torch.from_numpy(x).to(TDT[dtype]) for x in xs])


def _check(got, want, lengths, dtype):
    """Rows with a valid slot within TOL of ``want``; rows of length 0
    exactly zero."""
    got = got.float().numpy()
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    live = np.asarray(lengths) > 0
    np.testing.assert_allclose(got[live], want[live], atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert (got[~live] == 0).all()


# (b, h, kh, t, dh, lengths, starts): prefixes, rows of length 0 and 1,
# split edges, and ring runs that wrap inside a split.
CASES = [
    (4, 8, 2, 40, 32, [0, 1, 17, 40], None),
    (3, 4, 4, 64, 16, [63, 64, 0], None),
    (4, 8, 2, 40, 32, [0, 1, 17, 40], [0, 39, 30, 5]),
    (2, 10, 1, 33, 16, [33, 20], [32, 25]),
    (1, 4, 1, 5, 8, [3], [4]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 64])
@pytest.mark.parametrize("b,h,kh,t,dh,lengths,starts", CASES)
def test_split_ref_matches_decode_ref(b, h, kh, t, dh, lengths, starts,
                                      splits, dtype):
    """Every split count, more splits than rows included (empty splits
    write m = -1e30, l = 0 and weigh nothing), equals the unsplit plain
    version."""
    _, (q, k, v) = _inputs(b, h, kh, t, dh, dtype, seed=7)
    lens = torch.tensor(lengths, dtype=torch.int32)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32)
    got = ref.decode_attention_split_ref(q, k, v, lens, st, splits=splits)
    assert got.dtype == q.dtype
    _check(got, ref.decode_attention_ref(q, k, v, lens, st), lengths,
           dtype)


@pytest.mark.parametrize("splits", [1, 2, 5, 9])
def test_split_ranges_cover_each_run_position_once(splits):
    lens = torch.tensor([0, 1, 8, 9, 17, 40], dtype=torch.int32)
    j0, j1 = ref.decode_split_ranges(lens, 40, splits)
    assert j0.shape == j1.shape == (6, splits)
    for n, a, b in zip(lens.tolist(), j0.tolist(), j1.tolist()):
        cover = [j for lo, hi in zip(a, b) for j in range(lo, hi)]
        assert cover == list(range(n))
        per = -(-n // splits)
        assert all(hi - lo <= per for lo, hi in zip(a, b))


def test_a_ring_wrapping_inside_a_split_is_one_run():
    """A run that wraps at T in the middle of a split's positions reads
    the slots a prefix of the same keys laid out unwrapped reads."""
    _, (q, k, v) = _inputs(1, 4, 1, 16, 8, "float32", seed=9)
    start, n = 13, 10                  # slots 13, 14, 15, 0, ..., 6
    slots = [(start + j) % 16 for j in range(n)]
    lens = torch.tensor([n], dtype=torch.int32)
    ring = ref.decode_attention_split_ref(
        q, k, v, lens, torch.tensor([start], dtype=torch.int32), splits=2)
    flat = ref.decode_attention_split_ref(
        q, k[:, :, slots], v[:, :, slots], lens, None, splits=2)
    _check(ring, flat, [n], "float32")


# (b, h, kh, t, dh, lengths): T a multiple of the Pallas kernel's block_k.
PALLAS = [
    (2, 8, 2, 128, 32, [86, 103]),
    (3, 4, 4, 128, 64, [1, 128, 77]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,t,dh,lengths", PALLAS)
def test_split_ref_matches_pallas_interpret(b, h, kh, t, dh, lengths,
                                            dtype):
    (qj, kj, vj), (q, k, v) = _inputs(b, h, kh, t, dh, dtype, seed=8)
    lens = np.asarray(lengths, np.int32)
    want = pallas_decode(qj, kj, vj, jnp.asarray(lens), block_k=64,
                         interpret=True)
    for splits in (1, 3, 17):
        got = ref.decode_attention_split_ref(
            q, k, v, torch.from_numpy(lens), splits=splits)
        _check(got, want, lengths, dtype)


# (b, kh, t, g, dh): the serving decode shapes (yi-6b; recurrentgemma-2b
# at the calibration's cache and at its local ring of window + 1 slots).
SERVING = [(8, 4, 512, 8, 128), (8, 1, 512, 10, 256), (8, 1, 2049, 10, 256)]


@pytest.mark.parametrize("b,kh,t,g,dh", SERVING)
def test_planner_reaches_the_sms_at_the_serving_shapes(b, kh, t, g, dh):
    splits = tda.plan_splits(b, kh, t, g, dh, 2, 132)
    assert splits * b * kh >= 132
    assert splits == tda.plan_splits(b, kh, t, g, dh, 2, 132)
    # The f32 partials stay within the bytes of the caches' T rows.
    assert b * kh * splits * g * (dh + 2) * 4 <= 2 * b * kh * t * dh * 2


def test_planner_sees_shapes_only():
    """The split count is a function of shapes and the SM count: the
    lengths are never read on the host (that would synchronise every
    decode step)."""
    params = list(inspect.signature(tda.plan_splits).parameters)
    assert params == ["b", "kh", "t", "g", "dh", "esize", "sms"]
    assert tda.plan_splits(64, 4, 512, 8, 128, 2, 132) == 1   # >= 132 rows
    assert tda.plan_splits(8, 1, 17, 10, 256, 2, 132) == 1    # scratch cap
    assert tda.plan_splits(1, 1, 16, 1, 32, 4, 132) == 2      # row cap
    assert tda.plan_splits(1, 1, 1 << 20, 1, 32, 4, 1000) == \
        tda.MAX_SPLITS


def test_wrapper_on_cpu_tensors_runs_the_plain_version_for_any_split():
    """``splits`` is the card's keyword: on CPU tensors the plain version
    runs, and nothing launches."""
    _, (q, k, v) = _inputs(2, 4, 2, 16, 8, "float32", seed=1)
    lens = torch.tensor([16, 3], dtype=torch.int32)
    n0 = tda.decode_attention.launches
    got = tda.decode_attention(q, k, v, lens, splits=1)
    assert tda.decode_attention.launches == n0
    _check(got, ref.decode_attention_ref(q, k, v, lens), [16, 3], "float32")


def test_layout_is_checked_once_per_shape_and_strides(monkeypatch):
    """The wrapper's per-shape work (the checks, the ctypes stride array,
    the planned split) is cached on shapes and strides: the model's
    [B,T,K,dh] caches passed as transposed views give the strides of the
    view, q and the output their dense strides."""
    monkeypatch.setattr(tda, "_sm_count", lambda index: 132)
    b, h, kh, t, dh = 8, 32, 4, 512, 128
    q = torch.empty(b, h, dh, dtype=torch.bfloat16)
    cache = torch.empty(b, t, kh, dh, dtype=torch.bfloat16).transpose(1, 2)
    args = (-1, b, h, kh, t, dh, 2, q.stride(), cache.stride(),
            cache.stride())
    strides, planned = tda._layout(*args)
    assert list(strides) == [h * dh, dh, *cache.stride()[:3],
                             *cache.stride()[:3], h * dh, dh]
    assert planned == tda.plan_splits(b, kh, t, h // kh, dh, 2, 132) == 5
    assert tda._layout(*args)[0] is strides


@pytest.mark.parametrize("dh,qs,ks,match", [
    (96, (96, 96, 1), (4096, 1024, 96, 1), "head dims"),
    (32, (64, 32, 1), (8192, 32, 64, 2), "contiguous"),
    (32, (64, 32, 1), (1024, 1024, 33, 1), "16 bytes"),
])
def test_layout_raises_on_what_the_kernels_do_not_take(dh, qs, ks, match,
                                                      monkeypatch):
    monkeypatch.setattr(tda, "_sm_count", lambda index: 132)
    with pytest.raises(ValueError, match=match):
        tda._layout(-1, 2, 2, 1, 32, dh, 2, qs, ks, ks)
