"""The port's ``rglru_scan`` (its plain version, on CPU tensors) against the
JAX package's Pallas ``rglru_scan`` run as ``tests/test_kernels.py`` runs
it (interpret mode) and against its oracle ``ref.rglru_scan_ref``, on the
shapes of ``tests/test_kernels.py::test_rglru_scan_sweep`` plus ragged
ones (S = 7, R = 100) and a one-step scan from a carry (decode); and the
decode attention's ring run: ``decode_attention_ref`` with per-row ring
``starts`` against the JAX model's ``layers.decode_attention`` under its
position-aware mask, on a local block's ring before and after it wraps.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the scan in f32 within 1e-6 (absolute and relative).  XLA on
the CPU contracts the reference's ``a * h + x`` into one fused
multiply-add (jitted, eager and in the Pallas interpret mode alike; a
float64 emulation of the FMA equals all three on these inputs), where the
port rounds the product and the sum separately, as its CUDA kernel does
under ``-fmad=false``; the two differ by at most one ulp per step (4.8e-7
here), damped by ``a < 1``.  bf16 within 5 x ``TOL`` of
``tests/test_kernels.py`` (its bar for this kernel).  Attention within
``TOL`` (f32 3e-5, bf16 2e-2): the JAX model rounds the probabilities to
bf16 before P.V, the port does not.  The CUDA kernels are held against these
plain versions on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru_scan
from repro.models import layers as jlayers
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.models import layers as tlayers

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (b, s, r, h0): tests/test_kernels.py's shapes (Pallas blocks of 32).
PALLAS = [(2, 128, 64, False), (1, 512, 256, True), (4, 64, 128, True)]
# Ragged, one-step (decode) and tiny shapes: the oracle only.
RAGGED = [(3, 7, 100, True), (2, 7, 100, False), (2, 1, 100, True),
          (8, 1, 2560, True), (1, 3, 1, False)]


def _inputs(b, s, r, h0, seed=2):
    """a = sigmoid(normal) in (0, 1), as the model makes it; x normal;
    h0 normal f32 or None."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, r))))) \
        .astype(np.float32)
    x = rng.standard_normal((b, s, r)).astype(np.float32)
    h = rng.standard_normal((b, r)).astype(np.float32) if h0 else None
    return a, x, h


def _port(a, x, h, tdt):
    return rs.rglru_scan(torch.from_numpy(a).to(tdt),
                         torch.from_numpy(x).to(tdt),
                         None if h is None else torch.from_numpy(h))


def _jax(fn, a, x, h, jdt):
    out = fn(jnp.asarray(a).astype(jdt), jnp.asarray(x).astype(jdt),
             None if h is None else jnp.asarray(h))
    assert out.dtype == jdt
    return np.asarray(out.astype(jnp.float32))


def _assert_close(got, want, dtype, tdt):
    assert got.dtype == tdt
    got = got.float().numpy()
    tol = 1e-6 if dtype == "float32" else 5 * TOL[dtype]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,r,h0", PALLAS)
def test_plain_matches_pallas_interpret(b, s, r, h0, dtype):
    jdt, tdt = DTYPES[dtype]
    a, x, h = _inputs(b, s, r, h0)
    want = _jax(lambda *t: pallas_rglru_scan(*t, block_s=32, block_c=32,
                                             interpret=True), a, x, h, jdt)
    _assert_close(_port(a, x, h, tdt), want, dtype, tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,r,h0", PALLAS + RAGGED)
def test_plain_matches_jitted_reference_oracle(b, s, r, h0, dtype):
    jdt, tdt = DTYPES[dtype]
    a, x, h = _inputs(b, s, r, h0, seed=5)
    want = _jax(jax.jit(jref.rglru_scan_ref), a, x, h, jdt)
    _assert_close(_port(a, x, h, tdt), want, dtype, tdt)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    a, x, h = (torch.from_numpy(t) for t in _inputs(2, 9, 33, True))
    n0 = rs.rglru_scan.launches
    got = rs.rglru_scan(a, x, h)
    assert rs.rglru_scan.launches == n0
    assert torch.equal(got, rs.rglru_scan_ref(a, x, h))


def test_ops_dispatch_takes_the_model_layout():
    """The dispatch makes the operands contiguous and the carry f32, and
    sends every S (1 included) to the wrapper: no detour to an oracle."""
    a, x, h = (torch.from_numpy(t) for t in _inputs(2, 1, 40, True))
    at = a.transpose(0, 2).contiguous().transpose(0, 2)     # non-contiguous
    assert not at.is_contiguous()
    got = ops.rglru_scan(at, x, h.double())
    assert torch.equal(got, rs.rglru_scan_ref(a, x, h))


@pytest.mark.parametrize("case", ["dtype", "mixed", "h0_dtype", "shape",
                                  "h0_shape", "empty"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    a, x, h = (torch.from_numpy(t) for t in _inputs(1, 4, 8, True))
    if case == "dtype":
        a, x = a.double(), x.double()
    elif case == "mixed":
        x = x.bfloat16()
    elif case == "h0_dtype":
        h = h.bfloat16()
    elif case == "shape":
        x = x[:, :3]
    elif case == "h0_shape":
        h = h[:, :5]
    else:
        a, x = a[:, :0], x[:, :0]
    with pytest.raises((TypeError, ValueError)):
        rs.rglru_scan(a, x, h)


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device raises;
    the wrapper does not run the plain version for it."""
    a, x = (torch.empty((1, 2, 8), device="meta") for _ in range(2))
    with pytest.raises(ValueError, match="CUDA"):
        rs.rglru_scan(a, x)


# ---------------------------------------------------------------------------
# Decode attention on a local block's ring
# ---------------------------------------------------------------------------

def _reference_mask(last, t, window):
    """The JAX attention block's decode mask (``layers.py``'s
    position-aware validity), [T]."""
    pos = jlayers.cache_slot_positions(jnp.int32(last), t)
    valid = jnp.logical_and(pos >= 0, pos <= last)
    if window:
        valid = jnp.logical_and(valid, pos > last - window)
    return np.asarray(valid)


# (T, window, last position): the tiny config's ring (window 16, 17 slots)
# before it fills, as it wraps and after; a ring shorter than the window
# (serving's t_cache below window + 1); full attention (window 0).
RING = [(17, 16, l) for l in (0, 5, 15, 16, 17, 18, 33, 40)] + \
    [(8, 16, l) for l in (3, 7, 8, 20)] + [(16, 0, l) for l in (9, 16, 37)]


@pytest.mark.parametrize("t,window,last", RING)
def test_decode_run_is_the_reference_mask(t, window, last):
    """The position-aware mask is one run of slots in ring order, ending
    at the write slot: ``(start + j) mod T`` for ``j < length``."""
    want = _reference_mask(last, t, window)
    n, start = tlayers.decode_run(torch.tensor(last), t, window)
    got = np.zeros(t, bool)
    got[(int(start) + np.arange(int(n))) % t] = True
    assert got.tolist() == want.tolist()
    assert (int(start) + int(n) - 1) % t == last % t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,window,last", RING)
def test_ring_decode_matches_jax_decode_attention(t, window, last, dtype):
    """``decode_attention_ref`` with the ring run of each row, and the
    port's ``layers.decode_attention`` through the dispatch (CPU: no
    launch), against the JAX model's ``decode_attention`` under the
    position-aware mask.  A second batch row takes another start."""
    jdt, tdt = DTYPES[dtype]
    b, h, kh, dh = 2, 8, 2, 16
    rng = np.random.default_rng(last)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((b, 1, h, dh), (b, t, kh, dh), (b, t, kh, dh)))
    masks = np.stack([_reference_mask(last, t, window),
                      _reference_mask(last + 3, t, window)])
    want = jax.jit(lambda *a: jlayers.decode_attention(*a, dtype=jdt))(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
        jnp.asarray(masks))
    runs = [tlayers.decode_run(torch.tensor(l), t, window)
            for l in (last, last + 3)]
    lens = torch.stack([n for n, _ in runs]).to(torch.int32)
    starts = torch.stack([s for _, s in runs]).to(torch.int32)
    qt, kt, vt = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    ref = decode_attention_ref(qt[:, 0], kt.transpose(1, 2),
                               vt.transpose(1, 2), lens, starts)
    got = tlayers.decode_attention(qt, kt, vt, lens, starts, dtype=tdt)
    for out in (ref[:, None], got):
        assert out.dtype == tdt
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("b,s,r,backward,plan", [
    (1, 4096, 2560, False, (16, 160, 4, 64, 49_152)),   # training forward
    (1, 4096, 2560, True, (16, 160, 4, 64, 77_824)),    # its backward
    (8, 256, 2560, False, (32, 640, 4, 32, 45_056)),    # serving prefill
    (8, 1, 2560, False, (32, 640, 1, 1, 544)),          # decode
])
def test_launch_plan_at_the_serving_and_training_shapes(b, s, r, backward,
                                                         plan, monkeypatch):
    """32 channels a block where that still gives a block per SM of an
    H100 (132), else 16; stages of 64 steps for a grid of at most two
    blocks an SM, else 32; at most 4 stages, no more than chunks; the
    plan is cached per shape."""
    monkeypatch.setattr(rs, "sm_count", lambda index: 132)
    rs._plan.cache_clear()
    got = rs._plan(-1, b, s, r, 4, backward, None)
    assert got == rs.Plan(*plan) and got.blocks >= 132
    assert rs._plan(-1, b, s, r, 4, backward, None) is got
    rs._plan.cache_clear()
    assert rs.launch_plan(b, s, r, 4, 132, backward=backward,
                          channels=16).blocks == b * -(-r // 16)
    with pytest.raises(ValueError, match="channels"):
        rs.launch_plan(b, s, r, 4, 132, channels=8)
