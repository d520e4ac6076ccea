"""The port's xLSTM LM (plain path, CPU) against the JAX package's,
compiled (``jax.jit``): ``lm.prefill`` then four ``lm.decode_step``s
(logits at every step and the final cache), ``lm.forward``, and the cache
carried across both ways.  The configs, the weights carried across by
``params_from_reference`` and the tolerances are those of
``tests/test_torch_xlstm.py``: f32 within 1e-4, bf16 within 3% of the
reference's largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.kernels.ref import mlstm_scan_ref
from repro_torch.models import lm as tlm
from test_torch_xlstm import CONFIGS, assert_close, models

B, S, N_DECODE = 2, 12, 4


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_then_decode_matches_jitted_reference(name):
    cj, pj, ct, pt = models(name)
    toks = _tokens(cj.vocab, (B, S), seed=21)
    pre = jax.jit(lambda p, b, c: jlm.prefill(p, cj, b, c))
    dec = jax.jit(lambda p, t, l, c: jlm.decode_step(p, cj, t, l, c))
    lj, cache_j = pre(pj, {"tokens": jnp.asarray(toks)},
                      jlm.init_cache(cj, B, 32))
    lt, cache_t = tlm.prefill(pt, ct, {"tokens": torch.from_numpy(toks).long()},
                              tlm.init_cache(ct, B, 32, "cpu"))
    assert lt.shape == (B, 1, ct.vocab) and lt.dtype == torch.float32
    assert_close(lt.numpy(), lj, cj.dtype)
    len_j = jnp.full((B,), S, jnp.int32)
    len_t = torch.full((B,), S, dtype=torch.int32)
    for i in range(N_DECODE):
        tk = _tokens(cj.vocab, (B, 1), seed=30 + i)
        lj, cache_j, len_j = dec(pj, jnp.asarray(tk), len_j, cache_j)
        lt, cache_t, len_t = tlm.decode_step(
            pt, ct, torch.from_numpy(tk).long(), len_t, cache_t)
        assert_close(lt.numpy(), lj, cj.dtype)
    assert len_t.tolist() == np.asarray(len_j).tolist() == [S + N_DECODE] * B
    for got, want in zip(tlm.cache_to_reference(cache_t), cache_j):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32
            assert_close(got[k], want[k], cj.dtype)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_jitted_reference(name):
    cj, pj, ct, pt = models(name)
    toks = _tokens(cj.vocab, (B, S), seed=22)
    want = jax.jit(lambda p, b: jlm.forward(p, cj, b))(
        pj, {"tokens": jnp.asarray(toks)})
    got = tlm.forward(pt, ct, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (B, S, ct.vocab)
    assert_close(got.numpy(), want, cj.dtype)


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_continues_a_reference_cache(name):
    """A cache the JAX package filled, carried into the port, decodes to
    the logits the JAX package gives from it; and the carry round-trips
    bit for bit."""
    cj, pj, ct, pt = models(name)
    toks = _tokens(cj.vocab, (B, S), seed=23)
    _, cache_j = jax.jit(lambda p, b, c: jlm.prefill(p, cj, b, c))(
        pj, {"tokens": jnp.asarray(toks)}, jlm.init_cache(cj, B, 32))
    np_cache = jax.tree.map(np.asarray, cache_j)
    cache_t = tlm.cache_from_reference(np_cache, "cpu")
    back = tlm.cache_to_reference(cache_t)
    for got, want in zip(back, np_cache):
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()
    tk = _tokens(cj.vocab, (B, 1), seed=24)
    lens = np.full((B,), S, np.int32)
    lj, _, _ = jax.jit(lambda p, t, l, c: jlm.decode_step(p, cj, t, l, c))(
        pj, jnp.asarray(tk), jnp.asarray(lens), cache_j)
    lt, _, _ = tlm.decode_step(pt, ct, torch.from_numpy(tk).long(),
                               torch.from_numpy(lens), cache_t)
    assert_close(lt.numpy(), lj, cj.dtype)


def test_explicit_plain_scan_is_the_cpu_path():
    """On the CPU the kernel's wrapper runs the plain version, so passing
    it explicitly (as chip_smoke.py does on the card) changes nothing."""
    _, _, ct, pt = models("tiny-f32")
    toks = torch.from_numpy(_tokens(ct.vocab, (B, S), seed=25)).long()
    a, ca = tlm.prefill(pt, ct, {"tokens": toks},
                        tlm.init_cache(ct, B, 8, "cpu"))
    b, cb = tlm.prefill(pt, ct, {"tokens": toks},
                        tlm.init_cache(ct, B, 8, "cpu"),
                        mlstm_scan=mlstm_scan_ref)
    assert torch.equal(a, b)
    assert all(torch.equal(x[k], y[k]) for x, y in zip(ca, cb) for k in x)
