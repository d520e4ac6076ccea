"""The port's mixture-of-experts block (``repro_torch/models/moe.py``, plain
PyTorch on the CPU) against the JAX package's ``repro/models/moe.py``,
compiled (``jax.jit``), off the mesh: the capacity, the routing (expert
ids, positions in expert, kept pairs and the dispatch buffer exact; gates
and the load-balance term within 1e-6), the top-k order on ties, the
gate-weighted combine with dropped pairs (``capacity_factor=0.5``, so
positions pass the capacity and the reference's gather clamps them), the
experts' FFN (swiglu, geglu, gelu) and ``moe_apply``.

Two widths, those of phi3.5-moe's and grok-1's tiny configs (d_model 96
over 8 experts, swiglu; 128 over 4, geglu).  Inputs are made with numpy from a
seed.  Tolerances: f32 within 1e-4 (absolute and relative); bf16 within
3 % of the reference's largest magnitude
(``tests/test_torch_xlstm.py::assert_close``: the two sides sum the
products' f32 accumulators in other orders, then round once)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro_torch.configs import registry as treg
from repro_torch.models import layers
from repro_torch.models import moe as tmoe
from test_torch_xlstm import assert_close

ARCHS = ["phi35-moe-42b", "grok-1-314b"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def configs(arch, dtype="float32", **kw):
    """(JAX config, port config): the tiny config in ``dtype``."""
    return tuple(dataclasses.replace(c, dtype=dtype, **kw)
                 for c in (jreg.get_tiny(arch), treg.get_tiny(arch)))


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _pair(x, dtype):
    """A numpy array as (JAX, torch) arrays in ``dtype``."""
    return (jnp.asarray(x).astype(JDT[dtype]),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _params(cj, seed):
    """The expert weights of one MoE layer at the reference's scales, as
    (JAX tree, torch tree) in f32."""
    sch = jmoe.moe_schema(cj)
    out = ({}, {})
    for i, (name, ps) in enumerate(sorted(sch.items())):
        w = _normal(ps.shape, seed + i, ps.init[1])
        out[0][name], out[1][name] = jnp.asarray(w), torch.from_numpy(w)
    return out


def test_capacity_matches_reference():
    """Python float arithmetic over a call's tokens, at least 8, rounded
    up to 8: 320 slots for phi at a 2,048-token prefill, 640 for grok, 8
    at a decode step of 8 tokens."""
    for arch, want in (("phi35-moe-42b", 320), ("grok-1-314b", 640)):
        cj, ct = jreg.get(arch)[0], treg.get(arch)[0]
        assert tmoe._capacity(2048, ct) == jmoe._capacity(2048, cj) == want
        assert tmoe._capacity(8, ct) == jmoe._capacity(8, cj) == 8
        for n in (1, 7, 63, 64, 65, 1000, 4097):
            for cf in (0.5, 1.0, 1.25, 2.0):
                a, b = (dataclasses.replace(c, capacity_factor=cf)
                        for c in (cj, ct))
                assert tmoe._capacity(n, b) == jmoe._capacity(n, a)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_route_local_matches_jitted_reference(arch, dtype, cf):
    """256 tokens: the expert ids, positions in expert, kept pairs and
    the dispatch buffer exact; the gates and the load-balance term within
    1e-6.  At ``capacity_factor=0.5`` pairs are dropped."""
    cj, ct = configs(arch, dtype, capacity_factor=cf)
    t = 256
    cap = jmoe._capacity(t, cj)
    xj, xt = _pair(_normal((t, cj.d_model), 1), dtype)
    r = _normal((cj.d_model, cj.n_experts), 2, cj.d_model ** -0.5)
    rj, rt = _pair(r, dtype)
    bj, (ij, pj, kj, gj), aj = jax.jit(
        lambda x, w: jmoe._route_local(x, w, cj, cap))(xj, rj)
    bt, (it, pt, kt, gt), at = tmoe._route_local(xt, rt, ct, cap)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert bt.dtype == xt.dtype and bt.shape == (cj.n_experts, cap,
                                                 cj.d_model)
    np.testing.assert_array_equal(bt.float().numpy(),
                                  np.asarray(bj.astype(jnp.float32)))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(float(at), float(aj), atol=1e-6, rtol=1e-6)
    if cf < 1:
        assert not bool(kt.all()) and int(pt.max()) >= cap


def test_top_k_keeps_the_lower_expert_first_on_ties():
    """Rows with tied probabilities: the same ids and order as
    ``jax.lax.top_k`` (lower id first), where ``torch.topk`` gives no
    order."""
    rows = np.array([[0.25, 0.25, 0.25, 0.25],
                     [0.1, 0.4, 0.1, 0.4],
                     [0.4, 0.1, 0.4, 0.1],
                     [0.0, 0.3, 0.3, 0.4],
                     [0.5, 0.0, 0.0, 0.5]], np.float32)
    rows = np.concatenate([rows, np.repeat(rows[:1], 64, 0)])
    for k in (1, 2, 3):
        vj, ij = jax.lax.top_k(jnp.asarray(rows), k)
        vt, it = tmoe._top_k(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_local_with_dropped_pairs_matches_jitted_reference(arch,
                                                                   dtype):
    """``capacity_factor=0.5`` over 64 tokens: 8 slots, positions up to
    ~20.  Each side combines the same expert outputs with its own
    routing's metadata; a dropped pair's clamped row weighs 0."""
    cj, ct = configs(arch, dtype, capacity_factor=0.5)
    t = 64
    cap = jmoe._capacity(t, cj)
    xj, xt = _pair(_normal((t, cj.d_model), 3), dtype)
    rj, rt = _pair(_normal((cj.d_model, cj.n_experts), 4), dtype)
    _, mj, _ = jax.jit(lambda x, w: jmoe._route_local(x, w, cj, cap))(xj, rj)
    _, mt, _ = tmoe._route_local(xt, rt, ct, cap)
    assert int(mt[1].max()) >= cap and not bool(mt[2].all())
    oj, ot = _pair(_normal((cj.n_experts, cap, cj.d_model), 5), dtype)
    want = jax.jit(lambda o, m: jmoe._combine_local(o, m, JDT[dtype]))(oj, mj)
    got = tmoe._combine_local(ot, mt, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (t, cj.d_model)
    assert_close(got.float().numpy(), want.astype(jnp.float32), dtype)
    # The rows of tokens whose every pair was dropped are zeros.
    gone = ~mt[2].any(-1)
    assert bool(gone.any()) and bool((got[gone] == 0).all())


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_matches_jitted_reference(activation, dtype):
    """Each expert's FFN over a [E, C, D] buffer; the gated activations
    take the f32 gate product unrounded."""
    cj, ct = configs("phi35-moe-42b", dtype, activation=activation)
    pj, pt = _params(cj, 10)
    assert ("wg" in pj) == (activation != "gelu")
    bj, bt = _pair(_normal((cj.n_experts, 16, cj.d_model), 6), dtype)
    want = jax.jit(lambda p, b: jmoe._expert_ffn(p, b, cj, JDT[dtype]))(pj, bj)
    got = tmoe._expert_ffn(pt, bt, ct, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert_close(got.float().numpy(), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_gate_product_stays_f32_before_the_activation(arch):
    """In bf16 the port's experts agree with the reference's in nearly
    every element (bit for bit on this CPU), and rounding the gate product
    to bf16 before the activation, as the dense FFN does, moves over a
    tenth of them."""
    cj, ct = configs(arch, "bfloat16")
    pj, pt = _params(cj, 20)
    bj, bt = _pair(_normal((cj.n_experts, 16, cj.d_model), 7), "bfloat16")
    dt = torch.bfloat16
    want = np.asarray(jax.jit(lambda p, b: jmoe._expert_ffn(
        p, b, cj, jnp.bfloat16))(pj, bj).astype(jnp.float32))
    got = tmoe._expert_ffn(pt, bt, ct, dt).float().numpy()
    h = layers.ein("ecd,edf->ecf", bt, pt["w1"].to(dt), dtype=dt)
    g = layers.ein("ecd,edf->ecf", bt, pt["wg"].to(dt), dtype=dt)
    act = F.silu if ct.activation == "swiglu" else \
        (lambda v: F.gelu(v, approximate="tanh"))
    h = act(g.float()).to(dt) * h
    rounded = layers.ein("ecf,efd->ecd", h, pt["w2"].to(dt), dtype=dt)
    assert (got != want).mean() < 0.01
    assert (rounded.float().numpy() != want).mean() > 0.1


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 32), (8, 1)])
def test_moe_apply_matches_jitted_reference(arch, dtype, shape):
    """[B, S, D] -> ([B, S, D], aux): a prefill-sized call and a decode
    step's (8 tokens: the minimum capacity of 8)."""
    cj, ct = configs(arch, dtype)
    pj, pt = _params(cj, 30)
    b, s = shape
    xj, xt = _pair(_normal((b, s, cj.d_model), 8), dtype)
    yj, aj = jax.jit(lambda p, x: jmoe.moe_apply(p, x, cj))(pj, xj)
    yt, at = tmoe.moe_apply(pt, xt, ct)
    assert yt.dtype == getattr(torch, dtype) and yt.shape == xt.shape
    assert_close(yt.float().numpy(), yj.astype(jnp.float32), dtype)
    np.testing.assert_allclose(float(at), float(aj), atol=1e-6, rtol=1e-6)
