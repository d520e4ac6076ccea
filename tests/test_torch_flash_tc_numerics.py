"""The numerics of the tensor-core (bf16) route of ``flash_attention`` and
``flash_attention_bwd``, emulated in PyTorch on the CPU.

The CUDA kernels (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``)
run only on the card.  What they change against the plain versions is
where bf16 rounding happens, and that is emulated here step for step:
bf16 q, k, v and do, products exact in f32 (only their order of summation
differs); the forward's online softmax over kv tiles of 64 keys with each
tile's probabilities, relative to the running max, rounded to bf16 before
p.v, l summed from the f32 probabilities; in the backward, p rounded to
bf16 before dv and ds rounded to bf16 before dq and dk.

The emulation is held to the card's bars against the plain versions
(``chip_smoke.py``: ATTN_TOL bf16 2e-2 on the output, absolute and
relative, over rows with a visible key; the log-sum-exp rows within 1e-4;
FLASH_BWD_TOL bf16 5e-2 on dq, dk and dv, element by element) and
against the JAX model's own bf16-probability attention
(``repro.models.layers.attention``): the output within ATTN_TOL element
by element, and ``jax.grad`` within FLASH_BWD_TOL of each gradient's
largest magnitude (at least 1).  The model's backward rounds dP, the
cotangent of its bf16 probabilities, to bf16 as well, so element by
element even the plain f32 version is up to ~4 % of the largest
gradient away from it; the plain version is held to the same bar in
the same cases.  ``do`` is zero on rows that no key may see (the JAX
model gives such rows a mean of v, the port zeros).  Inputs are numpy
normals from a seed, handed to both packages.  Last, the bf16 route's
host-side rules: the TMA stride check and the dk/dv work split."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels.flash_attention import tma_ok, tma_strides
from repro_torch.kernels.flash_attention_bwd import dkv_splits
from repro_torch.kernels.ref import attention_mask, \
    flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref

ATTN_TOL = 2e-2          # chip_smoke.py: ATTN_TOL["bfloat16"]
FLASH_BWD_TOL = 5e-2     # chip_smoke.py: FLASH_BWD_TOL["bfloat16"]
LSE_TOL = 1e-4           # chip_smoke.py: lse_close
BK = 64                  # the kernels' kv tile

HEAD_DIMS = (32, 64, 128, 256)
HEADS = ((4, 4), (32, 4), (10, 1))
LENGTHS = ((1, 1), (63, 65), (77, 300), (129, 64))
CASES = [(dh, h, kh, s, t, causal, window)
         for dh in HEAD_DIMS for h, kh in HEADS for s, t in LENGTHS
         for causal in (True, False) for window in (0, 64)]
# Against JAX: every head dim, a ragged T past four kv tiles and a ragged
# S past two q tiles, GQA, causal with and without a window, and
# bidirectional.
JAX_CASES = [(dh, h, kh, s, t, causal, window)
             for dh in HEAD_DIMS for s, t in ((77, 300), (129, 64))
             for h, kh, causal, window in ((4, 4, True, 64),
                                           (10, 1, True, 0),
                                           (32, 4, False, 0))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Hundreds of small products: one intra-op thread runs them about 20x
    faster than a thread per core on a machine whose cores are busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(h, kh, s, t, dh, seed):
    """bf16 (q, k, v, do) from numpy normals, [B,H,S,dh] / [B,K,T,dh]."""
    rng = np.random.default_rng(seed)
    shapes = ((1, h, s, dh), (1, kh, t, dh), (1, kh, t, dh), (1, h, s, dh))
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            .to(torch.bfloat16) for sh in shapes]


def tc_forward(q, k, v, *, causal, window, scale=None):
    """The tensor-core forward's arithmetic: -> (out bf16, lse f32).  The
    scale is 1 / sqrt(dh) unless given (a head dim padded with zero
    columns keeps its true one)."""
    b, h, s, dh = q.shape
    kh, t = k.shape[1], k.shape[2]
    g = h // kh
    scale = np.float32(1.0 / np.sqrt(dh) if scale is None else scale)
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    mask = attention_mask(s, t, causal, window, q.device)
    m = torch.full((b, h, s), -1e30)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, dh))
    for k0 in range(0, t, BK):
        mk = mask[:, k0:k0 + BK]
        sc = torch.einsum("bhsd,bhtd->bhst", qf, kf[:, :, k0:k0 + BK]) \
            * scale
        sc = torch.where(mk, sc, torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mk, torch.exp(sc - m_new[..., None]),
                        torch.zeros(()))
        l = alpha * l + p.sum(dim=-1)
        m = m_new
        acc = acc * alpha[..., None] + torch.einsum(
            "bhst,bhtd->bhsd", p.bfloat16().float(), vf[:, :, k0:k0 + BK])
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).bfloat16()
    lse = torch.where(l > 0, m + torch.log(l), torch.tensor(float("inf")))
    return out, lse


def tc_backward(q, k, v, out, lse, do, *, causal, window):
    """The tensor-core backward's arithmetic: -> (dq, dk, dv) in bf16."""
    b, h, s, dh = q.shape
    kh, t = k.shape[1], k.shape[2]
    g = h // kh
    scale = np.float32(1.0 / np.sqrt(dh))
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    delta = (out.float() * dof).sum(dim=-1)
    mask = attention_mask(s, t, causal, window, q.device)
    sc = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    p = torch.where(mask, torch.exp(sc - lse[..., None]), torch.zeros(()))
    dp = torch.einsum("bhsd,bhtd->bhst", dof, vf)
    ds = (p * (dp - delta[..., None]) * scale).bfloat16().float()
    pb = p.bfloat16().float()
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf)
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf)
    dv = torch.einsum("bhst,bhsd->bhtd", pb, dof)
    dk = dk.reshape(b, kh, g, t, dh).sum(dim=2)
    dv = dv.reshape(b, kh, g, t, dh).sum(dim=2)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _seen(s, t, causal, window):
    """[S] bool: the rows that some key may see."""
    return attention_mask(s, t, causal, window, "cpu").any(dim=-1)


@pytest.mark.parametrize("dh,h,kh,s,t,causal,window", CASES)
def test_tc_rounding_within_the_cards_bars_of_the_plain_version(
        dh, h, kh, s, t, causal, window):
    q, k, v, do = _inputs(h, kh, s, t, dh, seed=dh + 7 * s + t)
    out, lse = tc_forward(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    seen = _seen(s, t, causal, window)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert bool((out[:, :, ~seen] == 0).all())
    assert torch.allclose(out[:, :, seen].float(), want[:, :, seen].float(),
                          atol=ATTN_TOL, rtol=ATTN_TOL)
    want_lse = flash_attention_lse_ref(q, k, causal=causal, window=window)
    fin = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    assert torch.allclose(lse[fin], want_lse[fin], atol=LSE_TOL, rtol=1e-5)
    got = tc_backward(q, k, v, out, lse, do, causal=causal, window=window)
    ref = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                  window=window)
    for a, w in zip(got, ref):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert bool(torch.isfinite(a).all())
        assert torch.allclose(a.float(), w.float(), atol=FLASH_BWD_TOL,
                              rtol=FLASH_BWD_TOL)


def _jax_attention_and_grads(q, k, v, do, causal, window):
    """The JAX model's attention ([B,S,H,dh] layout, bf16 probabilities)
    and jax.grad of sum(out * do), all in the port's [B,H,S,dh] layout."""
    tj = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          .transpose(0, 2, 1, 3) for x in (q, k, v, do)]

    def fwd(q, k, v):
        return jlayers.attention(q, k, v, causal=causal, window=window,
                                 dtype=jnp.bfloat16)

    def loss(q, k, v):
        return jnp.sum(fwd(q, k, v).astype(jnp.float32)
                       * tj[3].astype(jnp.float32))
    out = jax.jit(fwd)(*tj[:3])
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*tj[:3])
    back = lambda x: torch.from_numpy(
        np.array(x.astype(jnp.float32))).permute(0, 2, 1, 3)
    return back(out), [back(g) for g in grads]


@pytest.mark.parametrize("dh,h,kh,s,t,causal,window", JAX_CASES)
def test_tc_rounding_against_the_jax_models_bf16_attention(
        dh, h, kh, s, t, causal, window):
    q, k, v, do = _inputs(h, kh, s, t, dh, seed=3 * dh + s + 5 * t)
    seen = _seen(s, t, causal, window)
    do[:, :, ~seen] = 0
    out, lse = tc_forward(q, k, v, causal=causal, window=window)
    want, grads = _jax_attention_and_grads(q, k, v, do, causal, window)
    assert torch.allclose(out[:, :, seen].float(), want[:, :, seen],
                          atol=ATTN_TOL, rtol=ATTN_TOL)
    got = tc_backward(q, k, v, out, lse, do, causal=causal, window=window)
    plain = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                    window=window)
    for a, p, w in zip(got, plain, grads):
        bar = FLASH_BWD_TOL * max(1.0, float(w.abs().max()))
        assert float((a.float() - w).abs().max()) <= bar
        assert float((p.float() - w).abs().max()) <= bar


def test_tma_strides_take_the_models_views_and_raise_on_the_rest():
    """The bf16 route's operands: the model's transposed [B,S,H,dh]
    views pass as they are, a dimension of size 1 gets the dense stride,
    and a base or stride off 16 bytes raises by name."""
    x = torch.zeros((2, 300, 10, 64), dtype=torch.bfloat16)
    view = x.transpose(1, 2)                        # [B, H, S, dh]
    assert tma_strides(view, "q") == [view.stride(0), view.stride(1),
                                      view.stride(2)]
    assert tma_ok(view)
    one = torch.zeros((1, 1, 5, 32), dtype=torch.bfloat16).as_strided(
        (1, 1, 5, 32), (3, 1, 32, 1))
    assert tma_strides(one, "k") == [5 * 32, 5 * 32, 32]
    odd = torch.zeros((1, 2, 5, 36), dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="v's stride 36 of dim 2"):
        tma_strides(odd, "v")
    shifted = torch.zeros(1 + 2 * 5 * 32, dtype=torch.bfloat16)[1:] \
        .view(1, 2, 5, 32)
    with pytest.raises(ValueError, match="do must start"):
        tma_strides(shifted, "do")
    assert not tma_ok(shifted)


@pytest.mark.parametrize("b,kh,t,sms,want", [
    (1, 1, 4096, 132, 2),      # recurrentgemma-2b training: 64 tiles
    (1, 4, 4096, 132, 1),      # yi-6b training shape: 256 tiles
    (2, 1, 300, 132, 5),       # a sweep shape: 10 tiles, at most 5
    (8, 1, 256, 132, 4),       # recurrentgemma-2b prefill: 32 tiles
])
def test_dkv_splits_put_a_block_on_each_sm(b, kh, t, sms, want):
    assert dkv_splits(b, kh, t, sms) == want


# hubert-xlarge's attention: 16 q heads on 16 kv heads of 80,
# bidirectional; S/T of chip_smoke.py's phase 13j but its longest, and a
# GQA group with a causal window for the mask paths.
DH80_CASES = [(16, 16, s, t, False, 0)
              for s, t in ((1, 1), (63, 65), (77, 300), (1000, 1000))] \
    + [(8, 2, 129, 64, True, 64)]


@pytest.mark.parametrize("h,kh,s,t,causal,window", DH80_CASES)
def test_tc_forward_at_head_dim_80(h, kh, s, t, causal, window):
    """The bf16 route at head dim 80 keeps 128-column tiles whose columns
    80-127 TMA fills with zeros: those add exact zeros to q k^T and give
    zero output columns, so the padded arithmetic is the unpadded one bit
    for bit, and it holds the card's bar against the plain version and
    the JAX model's bf16 attention."""
    q, k, v, _ = _inputs(h, kh, s, t, 80, seed=80 + s + t)
    out, lse = tc_forward(q, k, v, causal=causal, window=window)
    pad = [torch.nn.functional.pad(x, (0, 48)) for x in (q, k, v)]
    out_p, lse_p = tc_forward(*pad, causal=causal, window=window,
                              scale=1.0 / np.sqrt(80))
    assert torch.equal(out_p[..., :80], out) and torch.equal(lse_p, lse)
    assert bool((out_p[..., 80:] == 0).all())
    seen = _seen(s, t, causal, window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert torch.allclose(out[:, :, seen].float(), want[:, :, seen].float(),
                          atol=ATTN_TOL, rtol=ATTN_TOL)
    jax_out, _ = _jax_attention_and_grads(q, k, v, torch.zeros_like(q),
                                          causal, window)
    assert torch.allclose(out[:, :, seen].float(), jax_out[:, :, seen],
                          atol=ATTN_TOL, rtol=ATTN_TOL)
