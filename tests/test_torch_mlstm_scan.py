"""The port's ``mlstm_scan`` (its plain version, on CPU tensors) against
the JAX package's Pallas ``mlstm_scan`` run as ``tests/test_kernels.py``
runs it (interpret mode) and against its oracle ``ref.mlstm_scan_ref``,
on the shapes of ``tests/test_kernels.py::test_mlstm_scan_sweep`` plus a
one-step scan with a carry (decode) and xlstm-125m's head width 192.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: h within ``TOL`` of ``tests/test_kernels.py`` (3e-5 in f32,
2e-2 in bf16, absolute and relative: the two sides' exp / log1p differ
in ulps and a bf16 h rounds once); the final carry in f32 within 1e-4
(C, n) and 1e-5 (m), as the JAX kernel test holds it.  The CUDA kernel
itself is held against this plain version on the card by
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mlstm_scan import mlstm_scan as pallas_mlstm_scan
from repro_torch.kernels import mlstm_scan as ms
from repro_torch.kernels import ops

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (b, h, s, dh, with_carry, Pallas block_s)
SHAPES = [
    (2, 2, 64, 32, False, 32),     # tests/test_kernels.py
    (1, 4, 128, 64, True, 32),     # tests/test_kernels.py
    (2, 2, 1, 32, True, 1),        # decode: one step from a carry
    (1, 2, 16, 192, True, 16),     # xlstm-125m's head width
    (2, 1, 8, 192, False, 8),
]


def _inputs(b, h, s, dh, with_carry, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, v = f(b, h, s, dh), f(b, h, s, dh)
    k = (f(b, h, s, dh) / np.sqrt(dh)).astype(np.float32)
    ig, fg = f(b, h, s), f(b, h, s) + 2.0
    carry = None
    if with_carry:
        carry = (np.abs(f(b, h, dh, dh)) * 0.1, np.abs(f(b, h, dh)) * 0.1,
                 f(b, h) * 0.5)
    return (q, k, v, ig, fg), carry


def _port(args, carry, tdt):
    q, k, v, ig, fg = args
    qkv = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    gates = [torch.from_numpy(x) for x in (ig, fg)]
    c = None if carry is None else tuple(torch.from_numpy(x) for x in carry)
    h, (C, n, m) = ms.mlstm_scan(*qkv, *gates, c)
    return h.float().numpy(), (C.numpy(), n.numpy(), m.numpy())


def _jax(fn, args, carry, jdt):
    q, k, v, ig, fg = args
    qkv = [jnp.asarray(x).astype(jdt) for x in (q, k, v)]
    c = None if carry is None else tuple(jnp.asarray(x) for x in carry)
    h, (C, n, m) = fn(*qkv, jnp.asarray(ig), jnp.asarray(fg), c)
    return np.asarray(h.astype(jnp.float32)), tuple(
        np.asarray(x) for x in (C, n, m))


def _assert_close(got, want, dtype):
    h, (C, n, m) = got
    wh, (wC, wn, wm) = want
    tol = TOL[dtype]
    np.testing.assert_allclose(h, wh, atol=tol, rtol=tol)
    np.testing.assert_allclose(C, wC, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(n, wn, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(m, wm, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,dh,with_carry,block_s", SHAPES)
def test_plain_matches_pallas_interpret(b, h, s, dh, with_carry, block_s,
                                        dtype):
    jdt, tdt = DTYPES[dtype]
    args, carry = _inputs(b, h, s, dh, with_carry)
    want = _jax(lambda *a: pallas_mlstm_scan(*a, block_s=block_s,
                                             interpret=True),
                args, carry, jdt)
    _assert_close(_port(args, carry, tdt), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,dh,with_carry,block_s", SHAPES)
def test_plain_matches_reference_oracle(b, h, s, dh, with_carry, block_s,
                                        dtype):
    jdt, tdt = DTYPES[dtype]
    args, carry = _inputs(b, h, s, dh, with_carry, seed=5)
    want = _jax(jref.mlstm_scan_ref, args, carry, jdt)
    _assert_close(_port(args, carry, tdt), want, dtype)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    args, carry = _inputs(1, 2, 4, 32, True)
    t = [torch.from_numpy(x) for x in args]
    c = tuple(torch.from_numpy(x) for x in carry)
    n0 = ms.mlstm_scan.launches
    got = ms.mlstm_scan(*t, c)
    want = ms.mlstm_scan_ref(*t, c)
    assert ms.mlstm_scan.launches == n0
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_ops_dispatch_takes_the_model_layout():
    """The dispatch makes the operands contiguous and the gates f32, and
    sends every S (1 included) to the wrapper: no detour to an oracle."""
    args, carry = _inputs(2, 2, 1, 32, True)
    q, k, v, ig, fg = (torch.from_numpy(x) for x in args)
    c = tuple(torch.from_numpy(x) for x in carry)
    qt = q.transpose(0, 1).contiguous().transpose(0, 1)   # non-contiguous
    assert not qt.is_contiguous()
    got = ops.mlstm_scan(qt, k, v, ig.double(), fg.double(), c)
    want = ms.mlstm_scan_ref(q, k, v, ig, fg, c)
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("case", ["dtype", "gate_dtype", "contiguous",
                                  "shape", "carry_shape", "empty"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    args, carry = _inputs(1, 2, 4, 32, True)
    q, k, v, ig, fg = (torch.from_numpy(x) for x in args)
    c = tuple(torch.from_numpy(x) for x in carry)
    if case == "dtype":
        q, k, v = (t.double() for t in (q, k, v))
    elif case == "gate_dtype":
        ig = ig.half()
    elif case == "contiguous":
        v = v.transpose(2, 3)
    elif case == "shape":
        k = k[:, :, :3]
    elif case == "carry_shape":
        c = (c[0][..., :16], c[1], c[2])
    else:
        q, k, v, ig, fg = (t[:, :, :0] for t in (q, k, v, ig, fg))
    with pytest.raises((TypeError, ValueError)):
        ms.mlstm_scan(q, k, v, ig, fg, c)


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device raises;
    the wrapper does not run the plain version for it."""
    q, k, v = (torch.empty((1, 1, 2, 32), device="meta") for _ in range(3))
    ig, fg = (torch.empty((1, 1, 2), device="meta") for _ in range(2))
    with pytest.raises(ValueError, match="CUDA"):
        ms.mlstm_scan(q, k, v, ig, fg)


def test_shared_memory_fits_head_dim_192():
    """xlstm-125m's heads (dh = 192) fit one block's shared memory; a head
    too wide for it is refused."""
    assert 48 * 1024 < ms.smem_bytes(192) <= 232_448
    assert ms.smem_bytes(256) > 232_448
