"""The port's attention kernels' plain versions and dispatch (CPU) against
the JAX package's: ``flash_attention_ref`` / ``decode_attention_ref``
against the Pallas TPU kernels run in interpret mode (as
``tests/test_kernels.py`` runs them) and against the JAX ``ref.py``
oracles, and ``kernels.ops`` on CPU tensors against the JAX dispatch,
including the shapes the JAX dispatch sends to its oracle (S = 1, T < 8).

Inputs are made with numpy from a seed; bf16 inputs are the same bits on
both sides.  Tolerance: ``tests/test_kernels.py``'s ``TOL`` (f32 3e-5,
bf16 2e-2, absolute and relative), on the output in f32.  Rows with no
valid key are not compared (the oracles give NaN there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shapes, dtype, seed):
    """(JAX arrays, torch tensors) of standard normals in ``dtype``."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(x).astype(JDT[dtype]) for x in xs],
            [torch.from_numpy(x).to(TDT[dtype]) for x in xs])


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    ok = np.isfinite(want)
    np.testing.assert_allclose(np.asarray(got, np.float32)[ok], want[ok],
                               atol=TOL[dtype], rtol=TOL[dtype])


# (b, h, kh, s, t, dh, causal, window): divisible by the Pallas blocks.
PALLAS_FLASH = [
    (2, 4, 4, 64, 64, 32, True, 0),        # MHA causal
    (1, 8, 2, 128, 128, 32, True, 0),      # GQA 4:1
    (1, 4, 4, 64, 128, 32, False, 0),      # bidirectional, longer K
    (1, 4, 1, 128, 128, 32, True, 32),     # MQA, local window
    (1, 4, 4, 64, 128, 80, False, 0),      # hubert's head dim, bidirectional
    (2, 4, 2, 128, 64, 80, False, 0),      # dh 80, GQA, S > T
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,s,t,dh,causal,window", PALLAS_FLASH)
def test_flash_ref_matches_pallas_interpret(b, h, kh, s, t, dh, causal,
                                            window, dtype):
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        [(b, h, s, dh), (b, kh, t, dh), (b, kh, t, dh)], dtype, seed=1)
    want = pallas_flash(qj, kj, vj, causal=causal, window=window,
                        block_q=32, block_k=32, interpret=True)
    got = tfa.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == TDT[dtype]
    _close(got, want, dtype)


# Ragged and degenerate shapes the Pallas kernel does not take.
RAGGED_FLASH = [
    (1, 4, 4, 200, 200, 16, True, 0),      # ragged S = T
    (2, 4, 1, 1, 7, 8, True, 0),           # S = 1, T < 8
    (1, 8, 2, 7, 1, 8, False, 0),          # T = 1
    (1, 4, 2, 37, 90, 16, False, 0),       # ragged, bidirectional
    (1, 8, 8, 100, 100, 16, True, 13),     # ragged window
    (1, 4, 1, 100, 30, 16, True, 0),       # causal with S > T
    (2, 4, 4, 77, 300, 80, False, 0),      # dh 80, ragged, bidirectional
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,s,t,dh,causal,window", RAGGED_FLASH)
def test_flash_ref_matches_jax_oracle(b, h, kh, s, t, dh, causal, window,
                                      dtype):
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        [(b, h, s, dh), (b, kh, t, dh), (b, kh, t, dh)], dtype, seed=2)
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    got = tfa.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,s,t,dh,causal,window",
                         [RAGGED_FLASH[1], RAGGED_FLASH[2], PALLAS_FLASH[1],
                          RAGGED_FLASH[4]])
def test_ops_flash_attention_on_cpu_tensors(b, h, kh, s, t, dh, causal,
                                            window, dtype):
    """The port's dispatch on CPU tensors runs the plain version (no
    launch) and agrees with the JAX dispatch, which sends S = 1 or T < 8
    to its oracle and the rest to the Pallas kernel; transposed views (the
    model's layout) give the same result."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        [(b, h, s, dh), (b, kh, t, dh), (b, kh, t, dh)], dtype, seed=3)
    n0 = tfa.flash_attention.launches
    got = tops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert tfa.flash_attention.launches == n0
    want = jops.flash_attention(qj, kj, vj, causal=causal, window=window)
    _close(got, want, dtype)
    qv, kv, vv = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (qt, kt, vt))
    again = tops.flash_attention(qv, kv, vv, causal=causal, window=window)
    assert torch.equal(again, got)


# (b, h, kh, t, dh, lengths)
DECODE = [
    (2, 8, 2, 256, 32, [86, 103]),
    (3, 4, 4, 128, 64, [1, 128, 77]),
    (1, 16, 2, 256, 32, [256]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,t,dh,lengths", DECODE)
def test_decode_ref_matches_pallas_interpret(b, h, kh, t, dh, lengths,
                                             dtype):
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        [(b, h, dh), (b, kh, t, dh), (b, kh, t, dh)], dtype, seed=4)
    lens = np.asarray(lengths, np.int32)
    want = pallas_decode(qj, kj, vj, jnp.asarray(lens), block_k=64,
                         interpret=True)
    got = tda.decode_attention_ref(qt, kt, vt, torch.from_numpy(lens))
    assert got.dtype == TDT[dtype]
    _close(got, want, dtype)


RAGGED_DECODE = [
    (8, 32, 4, 40, 16, [1, 17, 39, 40, 5, 24, 25, 33]),   # T not a block
    (2, 8, 8, 5, 8, [5, 2]),                              # T < 8
    (1, 4, 1, 1, 8, [1]),                                 # T = 1
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,t,dh,lengths", RAGGED_DECODE)
def test_decode_ref_and_ops_match_jax(b, h, kh, t, dh, lengths, dtype):
    """The plain version against the JAX oracle, and the port's dispatch
    on CPU tensors (no launch; the caches as transposed views, the
    model's layout) against the JAX dispatch."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        [(b, h, dh), (b, kh, t, dh), (b, kh, t, dh)], dtype, seed=5)
    lens = np.asarray(lengths, np.int32)
    want = jref.decode_attention_ref(qj, kj, vj, jnp.asarray(lens))
    _close(tda.decode_attention_ref(qt, kt, vt, torch.from_numpy(lens)),
           want, dtype)
    n0 = tda.decode_attention.launches
    kv, vv = (x.transpose(1, 2).contiguous().transpose(1, 2)
              for x in (kt, vt))
    got = tops.decode_attention(qt, kv, vv, torch.from_numpy(lens))
    assert tda.decode_attention.launches == n0
    _close(got, jops.decode_attention(qj, kj, vj, jnp.asarray(lens)), dtype)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 3, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="int32"):
        tda.decode_attention(q[:, :, 0], q, q, torch.ones(1))
    with pytest.raises(ValueError, match="cache"):
        tda.decode_attention(q[:, :, 0], q, q[:, :, :4],
                             torch.ones(1, dtype=torch.int32))


def test_head_dims_each_kernel_is_built_for():
    """The forward takes hubert-xlarge's head dim of 80 on both routes;
    the backward (its training) and decode (it is encoder-only) do not,
    so a dh-80 call of either raises on a CUDA tensor."""
    from repro_torch.kernels import flash_attention_bwd as tfb
    assert tfa.HEAD_DIMS == (32, 64, 80, 128, 256)
    assert 80 not in tfb.HEAD_DIMS and 80 not in tda.HEAD_DIMS
    assert set(tfb.HEAD_DIMS) == set(tda.HEAD_DIMS) == \
        set(tfa.HEAD_DIMS) - {80}
