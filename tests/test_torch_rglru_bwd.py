"""The port's RG-LRU scan backward on the CPU (``RGLRUScanFn`` through
autograd, whose backward there is the plain reverse loop
``rglru_scan_bwd_ref``) against the JAX package: ``jax.grad`` through its
oracle ``repro.kernels.ref.rglru_scan_ref`` (a ``lax.scan``), with and
without h0, and through the model's ``jax.lax.associative_scan`` mixer
(``repro/models/rglru.py:93-98``), which has no h0.  Also the backward's
plain form ``rglru_scan_bwd_ref`` (g in f32, rounded only where da and dx
are stored), which the CUDA backward kernel equals bit for bit on the
card (``chip_smoke.py``), in f32 and bf16: against ``jax.grad`` of the
oracle, and ``ops.rglru_scan``'s CPU backward against it exactly.

Inputs are made with numpy from a seed: a = sigmoid(normal) in (0, 1), as
the model makes it.  Tolerance in f32: 2e-6 absolute and relative for
the ``lax.scan`` oracle and 1e-5 for the associative scan.  XLA contracts
``a * h + x`` (and its transpose) into fused multiply-adds where the port
rounds the product and the sum separately, and the associative scan
combines in another order: about one ulp a step, damped by ``a < 1``
(ROADMAP C, "Scan order and FMA").  In bf16 2e-2 (``TOL`` of
``tests/test_kernels.py``), against ``jax.grad`` in f32 of the
bf16-rounded inputs: the port's h, da and dx are rounded to bf16 (a
relative 2^-8 each), its g is not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.rglru_scan import RGLRUScanFn, rglru_scan_bwd
from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref

SHAPES = [(2, 1, 8), (2, 7, 100), (1, 64, 32), (3, 33, 5)]


def _inputs(b, s, r, h0, seed):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, r))))) \
        .astype(np.float32)
    x = rng.standard_normal((b, s, r)).astype(np.float32)
    dh = rng.standard_normal((b, s, r)).astype(np.float32)
    c = rng.standard_normal((b, r)).astype(np.float32) if h0 else None
    return a, x, dh, c


def _port_grads(a, x, dh, c):
    leaves = [torch.from_numpy(t).requires_grad_() for t in (a, x)]
    if c is not None:
        leaves.append(torch.from_numpy(c).requires_grad_())
    h = ops.rglru_scan(*leaves)
    assert "RGLRUScanFn" in type(h.grad_fn).__name__
    return [g.numpy() for g in torch.autograd.grad(h, leaves,
                                                   torch.from_numpy(dh))]


def _jax_grads(fn, a, x, dh, c):
    args = (a, x) if c is None else (a, x, c)

    def loss(*args):
        return jnp.sum(fn(*args) * dh)
    return jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(
        *map(jnp.asarray, args))


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("b,s,r", SHAPES)
def test_rglru_bwd_matches_jax_grad_of_scan_oracle(b, s, r, h0):
    a, x, dh, c = _inputs(b, s, r, h0, seed=s * 7 + r)
    got = _port_grads(a, x, dh, c)
    want = _jax_grads(jref.rglru_scan_ref, a, x, dh, c)
    assert len(got) == len(want) == (3 if h0 else 2)
    for name, g, w in zip(("da", "dx", "dh0"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-6, rtol=2e-6,
                                   err_msg=name)


@pytest.mark.parametrize("b,s,r", SHAPES)
def test_rglru_bwd_matches_jax_grad_of_associative_scan(b, s, r):
    a, x, dh, _ = _inputs(b, s, r, False, seed=s + r)

    def mixer(a, x):
        def comb(l, rr):
            return l[0] * rr[0], rr[0] * l[1] + rr[1]
        return jax.lax.associative_scan(comb, (a, x), axis=1)[1]
    got = _port_grads(a, x, dh, None)
    want = _jax_grads(mixer, a, x, dh, None)
    for name, g, w in zip(("da", "dx"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("b,s,r", SHAPES)
def test_plain_backward_matches_jax_grad_and_ops_backward(b, s, r, h0):
    """In f32 and bf16: the plain reverse loop against ``jax.grad`` of the
    oracle in f32 (on the same, bf16-rounded, inputs), and autograd
    through ``ops.rglru_scan`` on the CPU equal to it bit for bit."""
    a, x, dh, c = _inputs(b, s, r, h0, seed=11 * s + r)
    for dtype, tol in ((torch.float32, 2e-6), (torch.bfloat16, 2e-2)):
        at, xt, dht = (torch.from_numpy(t).to(dtype) for t in (a, x, dh))
        ct = None if c is None else torch.from_numpy(c)
        h = rglru_scan_ref(at, xt, ct)
        want = rglru_scan_bwd_ref(at, h, dht, ct)
        assert [w is None for w in want] == [False, False, not h0]
        assert want[0].dtype == want[1].dtype == dtype
        rounded = [t.float().numpy() for t in (at, xt, dht)]
        jgrad = _jax_grads(jref.rglru_scan_ref, *rounded, c)
        for name, g, w in zip(("da", "dx", "dh0"), want, jgrad):
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w),
                                       atol=tol, rtol=tol,
                                       err_msg=f"{name} {dtype}")
        leaves = [at.clone().requires_grad_(), xt.clone().requires_grad_()]
        if ct is not None:
            leaves.append(ct.clone().requires_grad_())
        got = torch.autograd.grad(ops.rglru_scan(*leaves), leaves, dht)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        for g, w in zip(rglru_scan_bwd(at, h, dht, ct), want):
            assert (g is None and w is None) or torch.equal(g, w)


def test_plain_function_and_serving_path():
    """Autograd of the plain time loop (chip_smoke.py's plain path) gives
    the same gradients, bit for bit; under no_grad ops.rglru_scan records
    no graph."""
    a, x, dh, c = (torch.from_numpy(t) for t in _inputs(2, 9, 6, True, 5))
    leaves = [t.clone().requires_grad_() for t in (a, x, c)]
    want = torch.autograd.grad(ops.rglru_scan(*leaves), leaves, dh)
    got = torch.autograd.grad(rglru_scan_ref(*leaves), leaves, dh)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        h = ops.rglru_scan(*leaves)
    assert h.grad_fn is None and torch.equal(h, rglru_scan_ref(a, x, c))
    assert torch.equal(RGLRUScanFn.apply(a, x, c), h)
