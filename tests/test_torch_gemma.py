"""The port's gemma-7b (plain path, CPU) against the JAX package's,
compiled (``jax.jit``), with the JAX parameters carried across by
``params_from_reference``: the attention block's apply, prefill and
decode, ``lm.forward``, ``lm.prefill`` then 16 ``lm.decode_step``s, the
full config's parameter count from the schema (no weights built), the
registry, and the serving CLI with ``--tiny`` on the CPU.

Three configs: gemma-7b-tiny in f32 (d_model 64: sqrt(d) = 8 exactly),
gemma-7b-tiny in bf16, and a bf16 cut with d_model 96, where sqrt(d) is
not exact in bf16 and the f32 residual stream of an embedding-scaled model
shows.  Inputs are made with numpy from a seed.  Tolerances: f32 within
1e-4 (absolute and relative); bf16 within 3 % of the reference's largest
magnitude (``tests/test_torch_xlstm.py::assert_close``: the two sides
round different elements, and the port does attention's P.V in f32 where
the JAX model first rounds the probabilities to bf16)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from test_torch_xlstm import assert_close

ARCH = "gemma-7b"
CONFIGS = ["tiny-f32", "tiny-bf16", "d96-bf16"]
B = 2
N_PARAMS = 8_537_680_896


def configs(name):
    """(JAX config, port config) of one test config."""
    if name == "tiny-f32":
        return jreg.get_tiny(ARCH), treg.get_tiny(ARCH)
    kw = dict(dtype="bfloat16")
    if name == "d96-bf16":
        kw.update(d_model=96, d_ff=192)
    return tuple(dataclasses.replace(c, **kw)
                 for c in (jreg.get_tiny(ARCH), treg.get_tiny(ARCH)))


@functools.lru_cache(maxsize=None)
def models(name):
    """JAX config + params, port config + Model (same weights)."""
    cj, ct = configs(name)
    pj = jlm.init_params(cj, 0)
    pt = tlm.params_from_reference(ct, jax.tree.map(np.asarray, pj), "cpu")
    return cj, pj, ct, pt


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _x(cfg, shape, seed):
    """A residual-stream input in the dtype the reference's blocks see:
    f32 for an embedding-scaled model."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 4.0) \
        .astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _layer(name, i):
    _, pj, _, pt = models(name)
    return (jax.tree.map(lambda v: v[i], pj["layers"]),
            tlm._layer(pt.tree()["layers"], i))


@pytest.mark.parametrize("name", CONFIGS)
def test_attn_block_apply_and_prefill_match_jitted_reference(name):
    """A 12-token prompt into a 16-slot cache: the block's output (f32,
    as the reference's) and the filled cache (the compute dtype)."""
    cj, _, ct, _ = models(name)
    lj, lt = _layer(name, 1)
    s, t_cache = 12, 16
    xj, xt = _x(cj, (B, s, cj.d_model), 11)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy()
    shape = (B, t_cache, cj.n_kv_heads, cj.head_dim)
    cache_j = {k: jnp.zeros(shape, cj.compute_dtype()) for k in "kv"}
    cache_t = {k: torch.zeros(shape, dtype=ct.compute_dtype()) for k in "kv"}
    yj, nj = jax.jit(lambda p, x, c: jlayers.attn_block_prefill(
        p, x, cj, local=False, positions=jnp.asarray(pos), cache=c))(
        lj, xj, cache_j)
    yt, nt = tlayers.attn_block_prefill(lt, xt, ct, local=False,
                                        positions=torch.from_numpy(pos),
                                        cache=cache_t)
    assert yt.dtype == torch.float32 and yj.dtype == jnp.float32
    assert_close(yt.numpy(), yj, cj.dtype)
    for k in "kv":
        assert nt[k].dtype == ct.compute_dtype()
        assert_close(nt[k].float().numpy(), nj[k].astype(jnp.float32),
                     cj.dtype)
    at = tlayers.attn_block_apply(lt, xt, ct, local=False,
                                  positions=torch.from_numpy(pos))
    assert torch.equal(at, yt)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("length", [0, 7, 15])
def test_attn_block_decode_matches_jitted_reference(name, length):
    """One token at position ``length`` against a random 16-slot cache
    (full attention: the first ``length + 1`` slots are valid)."""
    cj, _, ct, _ = models(name)
    lj, lt = _layer(name, 0)
    shape = (B, 16, cj.n_kv_heads, cj.head_dim)
    rng = np.random.default_rng(21)
    kv = {k: rng.standard_normal(shape).astype(np.float32) for k in "kv"}
    cache_j = {k: jnp.asarray(v).astype(cj.compute_dtype())
               for k, v in kv.items()}
    cache_t = {k: torch.from_numpy(v).to(ct.compute_dtype())
               for k, v in kv.items()}
    xj, xt = _x(cj, (B, 1, cj.d_model), 23)
    lens = np.full((B,), length, np.int32)
    yj, nj = jax.jit(lambda p, x, c, l: jlayers.attn_block_decode(
        p, x, cj, local=False, positions=l[:, None], cache=c, lengths=l))(
        lj, xj, cache_j, jnp.asarray(lens))
    lt_ = torch.from_numpy(lens)
    yt, nt = tlayers.attn_block_decode(lt, xt, ct, local=False,
                                       positions=lt_[:, None],
                                       cache=cache_t, lengths=lt_)
    assert yt.dtype == torch.float32 and yj.dtype == jnp.float32
    assert_close(yt.numpy(), yj, cj.dtype)
    for k in "kv":
        assert nt[k].dtype == ct.compute_dtype()
        assert_close(nt[k].float().numpy(), nj[k].astype(jnp.float32),
                     cj.dtype)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_jitted_reference(name):
    cj, pj, ct, pt = models(name)
    toks = _tokens(cj.vocab, (B, 20), seed=22)
    want = jax.jit(lambda p, b: jlm.forward(p, cj, b))(
        pj, {"tokens": jnp.asarray(toks)})
    got = tlm.forward(pt, ct, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (B, 20, ct.vocab) and got.dtype == torch.float32
    assert_close(got.numpy(), want, cj.dtype)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_then_16_decode_steps_match_jitted_reference(name):
    """A 10-token prompt into a 32-slot cache, then 16 decode steps; the
    scanned stack's cache (one dict of stacked leaves) carried across both
    ways at the end."""
    cj, pj, ct, pt = models(name)
    s, n_decode, t_cache = 10, 16, 32
    toks = _tokens(cj.vocab, (B, s), seed=21)
    pre = jax.jit(lambda p, b, c: jlm.prefill(p, cj, b, c))
    dec = jax.jit(lambda p, t, l, c: jlm.decode_step(p, cj, t, l, c))
    lj, cache_j = pre(pj, {"tokens": jnp.asarray(toks)},
                      jlm.init_cache(cj, B, t_cache))
    lt, cache_t = tlm.prefill(pt, ct, {"tokens": torch.from_numpy(toks)
                                       .long()},
                              tlm.init_cache(ct, B, t_cache, "cpu"))
    assert lt.shape == (B, 1, ct.vocab) and lt.dtype == torch.float32
    assert_close(lt.numpy(), lj, cj.dtype)
    len_j = jnp.full((B,), s, jnp.int32)
    len_t = torch.full((B,), s, dtype=torch.int32)
    for i in range(n_decode):
        tk = _tokens(cj.vocab, (B, 1), seed=30 + i)
        lj, cache_j, len_j = dec(pj, jnp.asarray(tk), len_j, cache_j)
        lt, cache_t, len_t = tlm.decode_step(
            pt, ct, torch.from_numpy(tk).long(), len_t, cache_t)
        assert_close(lt.numpy(), lj, cj.dtype)
    assert len_t.tolist() == [s + n_decode] * B
    got = tlm.cache_to_reference(cache_t)
    assert sorted(got) == ["k", "v"]
    for k in "kv":
        w = np.asarray(cache_j[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape
        assert_close(got[k].astype(np.float32), w.astype(np.float32),
                     cj.dtype)


def test_full_config_parameter_count_and_registry():
    """8,537,680,896 parameters (34.2 GB in f32), counted from the schema
    without building a weight, as the reference's abstract parameters
    count; the config's fields are the reference's."""
    cj, meta_j = jreg.get(ARCH)
    ct, meta_t = treg.get(ARCH)
    assert tlm.n_params(ct) == N_PARAMS
    ref = sum(int(np.prod(a.shape))
              for a in jax.tree.leaves(jlm.abstract_params(cj)))
    assert ref == N_PARAMS
    assert dataclasses.asdict(ct) == {
        k: v for k, v in dataclasses.asdict(cj).items()
        if k in dataclasses.asdict(ct)}
    assert meta_t.source == meta_j.source == "arXiv:2403.08295"
    assert meta_t.train_microbatches == meta_j.train_microbatches
    assert dataclasses.asdict(treg.get_tiny(ARCH)) == {
        k: v for k, v in dataclasses.asdict(jreg.get_tiny(ARCH)).items()
        if k in dataclasses.asdict(treg.get_tiny(ARCH))}
    assert "gemma_7b" in treg.PORTED


def test_serve_main_tiny_on_the_cpu():
    """gemma-7b-tiny served on the CPU: the plain versions run (no kernel
    launch) and the engine answers requests under two schedulers."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    counters = (fa.flash_attention, da.decode_attention)
    n0 = [f.launches for f in counters]
    m = serve.main(["--arch", ARCH, "--tiny", "--rate", "0.5",
                    "--duration", "300", "--scheduler", "asl", "fifo"],
                   device="cpu")
    assert [f.launches for f in counters] == n0
    assert m["decode_step_s"] > 0 and m["prefill_chunk_s"] > 0
    assert set(m["by_scheduler"]) == {"asl", "fifo"}
    assert m["n"] > 0 and np.isfinite(m["ttft_p99"])
