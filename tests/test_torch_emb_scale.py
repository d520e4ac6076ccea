"""The residual stream of an embedding-scaled model (``emb_scale``) in
bf16: the reference multiplies the bf16 embedding by ``np.sqrt(d_model)``,
an f64 scalar that JAX takes as a strongly typed f32, so its residual
stream is f32 from the embedding on; its norms return f32, and each
projection (``jnp.einsum(..., preferred_element_type=bf16)``) rounds the
f32 activation to bf16 before the product.  The port must compute the
same: the embedding's bytes, each block's output dtype, and the logits.

Configs: recurrentgemma-tiny and gemma-7b-tiny in bf16 (d_model 96 and
64) and gemma's d_model-96 bf16 cut of ``tests/test_torch_gemma.py``, where
sqrt(d) is not exact in bf16.  Tolerances: the embedding and the mixed
einsums bit for bit; block outputs and logits within 3 % of the
reference's largest magnitude (``test_torch_xlstm.assert_close``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
import test_torch_gemma as tg
import test_torch_recurrentgemma as trg
from test_torch_xlstm import assert_close

MODELS = {"recurrentgemma-tiny-bf16": lambda: trg.models("tiny-bf16"),
          "gemma-tiny-bf16": lambda: tg.models("tiny-bf16"),
          "gemma-d96-bf16": lambda: tg.models("d96-bf16")}
B, S = 2, 12


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_mixed_einsum_matches_the_compiled_reference(out):
    """An f32 activation against bf16 weights, the result in ``out``: the
    port's ``ein`` equals the compiled ``jnp.einsum`` bit for bit (a bf16
    result: the activation rounded to bf16 first; an f32 result: the f32
    product of the unrounded activation)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((B, S, 96)) * 3).astype(np.float32)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    want = jax.jit(lambda a, b: jnp.einsum(
        "bsd,df->bsf", a, b, preferred_element_type=getattr(jnp, out)))(
        jnp.asarray(x), wj)
    got = tlayers.ein("bsd,df->bsf", torch.from_numpy(x),
                      torch.from_numpy(w).bfloat16(),
                      dtype=getattr(torch, out))
    assert str(want.dtype) == out and got.dtype == getattr(torch, out)
    assert got.float().numpy().tobytes() == \
        np.asarray(want, np.float32).tobytes()


@pytest.mark.parametrize("name", MODELS)
def test_embedding_is_the_references_f32_bytes(name):
    cj, pj, ct, pt = MODELS[name]()
    toks = np.random.default_rng(3).integers(0, cj.vocab, (B, S))
    want = jax.jit(lambda p, t: jlm._embed_tokens(p, cj, t))(
        pj, jnp.asarray(toks, jnp.int32))
    got = tlm._embed_tokens(pt.tree(), ct, torch.from_numpy(toks))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("name", MODELS)
def test_each_block_keeps_the_references_dtype(name):
    """The embedding through every block in turn, each side feeding its
    own output on (apply, as training and ``forward`` run them; then a
    prefill and one decode step of every block): each output's dtype is
    the reference's (f32), each within the bar, then the logits."""
    cj, pj, ct, pt = MODELS[name]()
    toks = np.random.default_rng(4).integers(0, cj.vocab, (B, S + 1))
    tj = jnp.asarray(toks, jnp.int32)
    tt = torch.from_numpy(toks)
    p = pt.tree()
    lj_all = (pj["blocks"] if "blocks" in pj else
              [jax.tree.map(lambda v, i=i: v[i], pj["layers"])
               for i in range(cj.n_layers)])
    pos_j = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    pos_t = torch.from_numpy(np.array(pos_j))
    cj_l = jlm.init_cache(cj, B, 2 * S)
    cj_l = cj_l if isinstance(cj_l, list) else \
        [jax.tree.map(lambda v, i=i: v[i], cj_l) for i in range(cj.n_layers)]
    ct_l = tlm._layer_caches(tlm.init_cache(ct, B, 2 * S, "cpu"), ct)
    xj = jlm._embed_tokens(pj, cj, tj[:, :S])
    xt = tlm._embed_tokens(p, ct, tt[:, :S])
    yj, yt = xj, xt
    lens_j = jnp.full((B,), S, jnp.int32)
    lens_t = torch.full((B,), S, dtype=torch.int32)
    dj = jlm._embed_tokens(pj, cj, tj[:, S:])
    dt = tlm._embed_tokens(p, ct, tt[:, S:])
    for kind, lj, (_, lt), cache_j, cache_t in zip(
            cj.blocks(), lj_all, tlm._layers(p, ct), cj_l, ct_l):
        xj = jax.jit(lambda q, x, f=jlm.BLOCK_APPLY[kind]: f(
            q, x, cj, positions=pos_j))(lj, xj)
        xt = tlm.BLOCK_APPLY[kind](lt, xt, ct, positions=pos_t)
        yj, nj = jax.jit(lambda q, x, c, f=jlm.BLOCK_PREFILL[kind]: f(
            q, x, cj, positions=pos_j, cache=c))(lj, yj, cache_j)
        yt, nt = tlm.BLOCK_PREFILL[kind](lt, yt, ct, positions=pos_t,
                                         cache=cache_t)
        dj, _ = jax.jit(lambda q, x, c, n, f=jlm.BLOCK_DECODE[kind]: f(
            q, x, cj, positions=n[:, None], cache=c, lengths=n))(
            lj, dj, nj, lens_j)
        dt, _ = tlm.BLOCK_DECODE[kind](lt, dt, ct, positions=lens_t[:, None],
                                       cache=nt, lengths=lens_t)
        for got, want in ((xt, xj), (yt, yj), (dt, dj)):
            assert str(got.dtype) == f"torch.{want.dtype}" == "torch.float32"
            assert_close(got.numpy(), want, cj.dtype)
        for k in nj:
            assert str(nt[k].dtype) == f"torch.{nj[k].dtype}"
    logits_j = jlm._unembed(pj, cj, xj)
    logits_t = tlm._unembed(p, ct, xt)
    assert logits_t.dtype == torch.float32 and logits_j.dtype == jnp.float32
    assert_close(logits_t.numpy(), logits_j, cj.dtype)
