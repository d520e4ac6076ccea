"""The port's flash-attention backward on the CPU (its plain version, and
``FlashAttentionFn`` through autograd) against the JAX package: ``jax.grad``
of the oracle ``repro.kernels.ref.flash_attention_ref`` and the TPU
kernels' own ``flash_attention_vjp`` run as ``tests/test_kernels_bwd.py``
runs them (interpret mode, blocks of 32), on that file's shapes (GQA, MHA,
MQA with a window, bidirectional) in f32 and bf16; ragged S and T against
``jax.grad`` alone (the TPU kernels need S and T to be multiples of their
blocks); and the forward's log-sum-exp rows against the reference's
``_fwd_lse``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are ``tests/test_kernels_bwd.py``'s for this kernel: 5e-5 in
f32 and 5e-2 in bf16, absolute and relative (the sums run in other
orders); the log-sum-exp rows within 1e-5.  The CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention_bwd import _fwd_lse, flash_attention_vjp
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_bwd import FlashAttentionFn, \
    flash_attention_bwd
from repro_torch.kernels.ref import flash_attention_bwd_ref, \
    flash_attention_lse_ref, flash_attention_ref

TOL = {"float32": 5e-5, "bfloat16": 5e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels_bwd.py's shapes: (b, h, kh, s, dh, causal, window).
SHAPES = [
    (1, 4, 2, 128, 32, True, 0),      # GQA causal
    (2, 2, 2, 64, 32, True, 0),       # MHA causal
    (1, 2, 1, 128, 64, True, 32),     # MQA + local window
    (1, 2, 2, 64, 32, False, 0),      # bidirectional
]
# Ragged: (b, h, kh, s, t, dh, causal, window); every query sees a key.
RAGGED = [
    (1, 4, 2, 77, 300, 32, False, 0),
    (2, 2, 1, 77, 300, 64, True, 0),
    (1, 4, 1, 100, 77, 32, True, 64),
    (1, 2, 2, 45, 45, 24, True, 16),
    (1, 2, 1, 1, 1, 32, True, 0),
]


def _inputs(b, h, kh, s, t, dh, dtype, seed):
    """(jax q, k, v, do), (torch q, k, v, do): numpy normals in ``dtype``."""
    rng = np.random.default_rng(seed)
    shapes = ((b, h, s, dh), (b, kh, t, dh), (b, kh, t, dh), (b, h, s, dh))
    xs = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(x).astype(jdt) for x in xs],
            [torch.from_numpy(x).to(tdt) for x in xs])


def _jax_grads(fn, q, k, v, do):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32)
                       * do.astype(jnp.float32))
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)


def _port_grads(q, k, v, do, causal, window):
    """dq, dk, dv through ``ops.flash_attention`` under autograd (which
    dispatches to ``FlashAttentionFn``)."""
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None and \
        "FlashAttentionFn" in type(out.grad_fn).__name__
    return torch.autograd.grad(out, leaves, do)


def _close(got, want, dtype, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype],
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,s,dh,causal,window", SHAPES)
def test_flash_bwd_matches_jax_grad_and_pallas_vjp(b, h, kh, s, dh, causal,
                                                   window, dtype):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(b, h, kh, s, s, dh, dtype, 0)
    want = _jax_grads(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=causal, window=window), jq, jk, jv, jdo)
    pallas = _jax_grads(lambda q, k, v: flash_attention_vjp(
        q, k, v, causal, window, 32, 32, True), jq, jk, jv, jdo)
    got = _port_grads(q, k, v, do, causal, window)
    for g, x in zip(got, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
    _close(got, want, dtype, "FlashAttentionFn vs jax.grad")
    _close(got, pallas, dtype, "FlashAttentionFn vs flash_attention_vjp")
    # The plain backward called directly, on the plain forward's rows.
    out = flash_attention_ref(q, k, v, causal=causal, window=window)
    lse = flash_attention_lse_ref(q, k, causal=causal, window=window)
    plain = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                    window=window)
    _close(plain, want, dtype, "flash_attention_bwd_ref vs jax.grad")
    # The wrapper on CPU tensors is the plain version.
    for a, w in zip(flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                        window=window), plain):
        assert torch.equal(a, w)


@pytest.mark.parametrize("b,h,kh,s,t,dh,causal,window", RAGGED)
def test_flash_bwd_ragged_matches_jax_grad(b, h, kh, s, t, dh, causal,
                                           window):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(b, h, kh, s, t, dh,
                                               "float32", 1)
    want = _jax_grads(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=causal, window=window), jq, jk, jv, jdo)
    _close(_port_grads(q, k, v, do, causal, window), want, "float32",
           "ragged FlashAttentionFn vs jax.grad")
    # Autograd of the plain forward (chip_smoke.py's plain path) is the
    # same function.
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention_ref(*leaves, causal=causal, window=window)
    _close(torch.autograd.grad(out, leaves, do), want, "float32",
           "autograd of flash_attention_ref vs jax.grad")


@pytest.mark.parametrize("b,h,kh,s,dh,causal,window", SHAPES)
def test_lse_matches_reference_fwd_lse(b, h, kh, s, dh, causal, window):
    (jq, jk, jv, _), (q, k, v, _) = _inputs(b, h, kh, s, s, dh, "float32",
                                            2)
    jout, jlse = _fwd_lse(jq, jk, jv, causal=causal, window=window,
                          block_q=32, block_k=32, interpret=True)
    out, lse = flash_attention(q, k, v, causal=causal, window=window,
                               return_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=3e-5,
                               rtol=3e-5)
    assert torch.equal(lse, flash_attention_lse_ref(q, k, causal=causal,
                                                    window=window))


def test_lse_of_a_row_no_key_sees_is_inf_and_its_grads_zero():
    """Causal with a window, S > T: rows past T + window - 1 see no key;
    their log-sum-exp is +inf, so every gradient of them is 0."""
    _, (q, k, v, do) = _inputs(1, 2, 1, 12, 4, 8, "float32", 3)
    lse = flash_attention_lse_ref(q, k, causal=True, window=3)
    assert torch.isinf(lse[..., 6:]).all() and (lse[..., 6:] > 0).all()
    assert torch.isfinite(lse[..., :6]).all()
    out = torch.nan_to_num(flash_attention_ref(q, k, v, causal=True,
                                               window=3))
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True,
                                         window=3)
    assert (dq[..., 6:, :] == 0).all()
    assert all(torch.isfinite(x).all() for x in (dq, dk, dv))


def test_serving_path_does_not_record_a_graph():
    """Under no_grad (serving) ops.flash_attention goes straight to the
    wrapper: no autograd Function, the same values."""
    _, (q, k, v, _) = _inputs(1, 4, 2, 16, 16, 8, "float32", 4)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        out = ops.flash_attention(*leaves, causal=True, window=0)
    assert out.grad_fn is None
    assert torch.equal(out, flash_attention_ref(q, k, v, causal=True))
    assert torch.equal(FlashAttentionFn.apply(*leaves, True, 0).detach(),
                       out)


def _model_layout_grads(q, k, v, loss):
    """dq, dk, dv through ops.flash_attention with the model's layout:
    [B,S,H,dh] leaves passed transposed, the output transposed back and
    flattened to [B,S,H*dh] before ``loss``."""
    leaves = [x.transpose(1, 2).contiguous().requires_grad_()
              for x in (q, k, v)]
    out = ops.flash_attention(*(x.transpose(1, 2) for x in leaves),
                              causal=True, window=0)
    b, h, s, dh = out.shape
    loss(out.transpose(1, 2).reshape(b, s, h * dh)).backward()
    return [x.grad for x in leaves]


def test_model_layout_gradient_reaches_the_backward_uncopied():
    """The gradient a model hands FlashAttentionFn (the output flattened,
    then projected) has a contiguous head dim: no copy is made."""
    _, (q, k, v, _) = _inputs(1, 4, 2, 32, 32, 16, "float32", 5)
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4 * 16, 8)).astype(np.float32))
    FlashAttentionFn.do_copies = 0
    grads = _model_layout_grads(q, k, v, lambda o: (o @ w).square().sum())
    assert FlashAttentionFn.do_copies == 0
    assert all(torch.isfinite(g).all() for g in grads)


def test_strided_incoming_gradient_is_copied_and_counted():
    """A gradient with a strided head dim (``sum``'s expanded ones) is
    copied once, counted, and gives the gradients of the same values
    materialised."""
    _, (q, k, v, _) = _inputs(1, 4, 2, 32, 32, 16, "float32", 7)
    FlashAttentionFn.do_copies = 0
    got = _model_layout_grads(q, k, v, lambda o: o.sum())
    assert FlashAttentionFn.do_copies == 1
    want = _model_layout_grads(q, k, v, lambda o: (o * torch.ones_like(
        o)).sum())
    assert FlashAttentionFn.do_copies == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
