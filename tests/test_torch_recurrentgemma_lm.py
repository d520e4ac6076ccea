"""The port's recurrentgemma-2b model as a whole (plain path, CPU) against
the JAX package's, compiled (``jax.jit``): ``lm.forward``, ``lm.prefill``
then 40 ``lm.decode_step``s with the local blocks on a ring of 17 slots
(the tiny config's window + 1, which the steps wrap three times), the
caches carried across both ways, the mixed tree of parameters, the plain
kernels passed by name, and the serving CLI on the CPU.  The configs and
tolerances are ``tests/test_torch_recurrentgemma.py``'s (f32 within 1e-4;
bf16 within 3 % of the reference's largest magnitude)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.kernels.ref import decode_attention_ref, \
    flash_attention_ref, rglru_scan_ref
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from test_torch_recurrentgemma import ARCH, B, CONFIGS, models
from test_torch_xlstm import assert_close


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _trees_close(got, want, dtype, exact=False):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if exact:
            assert g.tobytes() == w.tobytes()
        else:
            assert_close(g.astype(np.float32), w.astype(np.float32), dtype)


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
def test_prefill_then_40_decode_steps_match_jitted_reference(name):
    """A 10-token prompt, then 40 decode steps at t_cache 17: the local
    blocks' ring of 17 slots wraps at positions 17, 34 and 51, and the
    RG-LRU state carries across all 40 steps."""
    cj, pj, ct, pt = models(name)
    s, n_decode, t_cache = 10, 40, 17
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
    _trees_close(tlm.cache_to_reference(cache_t),
                 jax.tree.map(np.asarray, cache_j), cj.dtype)


@pytest.mark.parametrize("name", CONFIGS)
def test_cache_round_trips_and_decodes_as_the_reference(name):
    """A cache the JAX package filled (the per-layer list: KV rings in the
    compute dtype, RG-LRU ``h`` [B,R] and ``conv`` [B,3,R] in f32) comes
    across and back bit for bit and decodes to the JAX package's logits;
    an initial cache matches the reference's leaf for leaf."""
    cj, pj, ct, pt = models(name)
    toks = _tokens(cj.vocab, (B, 9), seed=23)
    _, cache_j = jax.jit(lambda p, b, c: jlm.prefill(p, cj, b, c))(
        pj, {"tokens": jnp.asarray(toks)}, jlm.init_cache(cj, B, 16))
    np_cache = jax.tree.map(np.asarray, cache_j)
    cache_t = tlm.cache_from_reference(np_cache, "cpu")
    assert [sorted(c) for c in cache_t] == [["conv", "h"], ["conv", "h"],
                                            ["k", "v"]]
    assert cache_t[0]["h"].dtype == cache_t[0]["conv"].dtype == torch.float32
    assert cache_t[0]["conv"].shape == (B, 3, ct.rnn_width)
    _trees_close(tlm.cache_to_reference(cache_t), np_cache, cj.dtype,
                 exact=True)
    tk = _tokens(cj.vocab, (B, 1), seed=24)
    lens = np.full((B,), 9, np.int32)
    lj, _, _ = jax.jit(lambda p, t, l, c: jlm.decode_step(p, cj, t, l, c))(
        pj, jnp.asarray(tk), jnp.asarray(lens), cache_j)
    lt, _, _ = tlm.decode_step(pt, ct, torch.from_numpy(tk).long(),
                               torch.from_numpy(lens), cache_t)
    assert_close(lt.numpy(), lj, cj.dtype)
    _trees_close(tlm.cache_to_reference(tlm.init_cache(ct, 3, 16, "cpu")),
                 jax.tree.map(np.asarray, jlm.init_cache(cj, 3, 16)),
                 cj.dtype, exact=True)


def test_params_from_reference_keeps_the_mixed_tree():
    """recurrentgemma is a mixed stack: every leaf under ``blocks.<i>.``,
    named and valued as the JAX tree (tied embeddings: no unembed)."""
    _, pj, _, pt = models("tiny-f32")
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(pj)[0]}
    got = dict(pt.named_parameters())
    assert set(got) == set(flat)
    assert {"embed", "final_ln", "blocks.0.lam", "blocks.1.conv_w",
            "blocks.2.wq", "blocks.2.mlp.wg"} <= set(got)
    assert "unembed" not in got
    for k, v in flat.items():
        assert got[k].dtype == torch.float32
        assert got[k].numpy().tobytes() == v.astype(np.float32).tobytes()


def test_explicit_plain_kernels_are_the_cpu_path():
    """On the CPU the kernels' wrappers run the plain versions, so passing
    them explicitly (as chip_smoke.py does on the card) changes nothing,
    through a prefill and two decode steps on a wrapped ring."""
    _, _, ct, pt = models("tiny-bf16")
    toks = torch.from_numpy(_tokens(ct.vocab, (B, 20), seed=25)).long()
    plain = dict(rglru_scan=rglru_scan_ref,
                 flash_attention=flash_attention_ref,
                 decode_attention=decode_attention_ref)
    runs = []
    for kw in ({}, plain):
        lo, cache = tlm.prefill(pt, ct, {"tokens": toks},
                                tlm.init_cache(ct, B, 17, "cpu"), **kw)
        lens = torch.full((B,), 20, dtype=torch.int32)
        outs = [lo]
        for i in range(2):
            ld, cache, lens = tlm.decode_step(pt, ct, toks[:, i:i + 1], lens,
                                              cache, **kw)
            outs.append(ld)
        runs.append((outs, cache))
    (a, c), (x, z) = runs
    assert all(torch.equal(u, w) for u, w in zip(a, x))
    assert all(torch.equal(c[i][k], z[i][k]) for i in range(3) for k in c[i])


def test_serve_main_on_the_cpu():
    """recurrentgemma-tiny served on the CPU: the plain versions run (no
    kernel launch) and the engine answers requests."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rs
    counters = (rs.rglru_scan, fa.flash_attention, da.decode_attention)
    n0 = [f.launches for f in counters]
    m = serve.main(["--arch", ARCH, "--tiny", "--rate", "0.1",
                    "--duration", "600", "--scheduler", "asl", "fifo"],
                   device="cpu")
    assert [f.launches for f in counters] == n0
    assert m["decode_step_s"] > 0 and m["prefill_chunk_s"] > 0
    assert set(m["by_scheduler"]) == {"asl", "fifo"}
    assert m["n"] > 0 and np.isfinite(m["ttft_p99"])
