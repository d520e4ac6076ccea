"""The port's recurrentgemma-2b blocks (plain path, CPU) against the JAX
package's, compiled (``jax.jit``), with the JAX parameters carried across
by ``params_from_reference``: the RG-LRU block's apply, prefill (with its
state) and decode (from a carry), and the local attention block's
prefill (with and without the ring roll) and decode on a ring of
``window + 1`` slots before, as and after it wraps; the schema, the
parameter count and the registry.  Three configs: recurrentgemma-tiny in
f32 (window 16), recurrentgemma-tiny in bf16, and recurrentgemma-2b's
full width (d_model 2560, rnn width 2560, 10 q heads and 1 kv head of
256, d_ff 7680, bf16) cut to one pattern of 3 layers and a vocab of 512.
``tests/test_torch_recurrentgemma_lm.py`` holds the whole model.

Inputs are made with numpy from a seed.  Tolerances, in the compute
dtype: f32 within 1e-4 (absolute and relative): the JAX prefill runs
``jax.lax.associative_scan`` over the recurrence, which rounds in another
order than the port's sequential scan, XLA contracts its decode's
``a * h + b`` into a fused multiply-add, and the two sides' exp, expm1,
sigmoid and tanh differ in ulps.  bf16 within 3 % of the reference's
largest magnitude (max abs difference), as ``tests/test_torch_xlstm.py``
states: the two sides round different elements of the same bf16
activations, and the port does attention's P.V in f32 where the JAX
model first rounds the probabilities to bf16."""

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
from repro.models import rglru as jrg
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import rglru as trg
from test_torch_xlstm import assert_close

ARCH = "recurrentgemma-2b"
CONFIGS = ["tiny-f32", "tiny-bf16", "wide-3l"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
B = 2


def configs(name):
    """(JAX config, port config) of one test config."""
    if name == "tiny-f32":
        return jreg.get_tiny(ARCH), treg.get_tiny(ARCH)
    if name == "tiny-bf16":
        return tuple(dataclasses.replace(c, dtype="bfloat16") for c in
                     (jreg.get_tiny(ARCH), treg.get_tiny(ARCH)))
    kw = dict(n_layers=3, vocab=512)
    return (dataclasses.replace(jreg.get(ARCH)[0], **kw),
            dataclasses.replace(treg.get(ARCH)[0], **kw))


@functools.lru_cache(maxsize=None)
def models(name):
    """JAX config + params, port config + Model (same weights)."""
    cj, ct = configs(name)
    pj = jlm.init_params(cj, 0)
    pt = tlm.params_from_reference(ct, jax.tree.map(np.asarray, pj), "cpu")
    return cj, pj, ct, pt


def layer(name, i):
    """(JAX, port) parameters of layer ``i`` (0: RG-LRU, 2: local
    attention)."""
    _, pj, _, pt = models(name)
    return pj["blocks"][i], pt.tree()["blocks"][i]


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(x, dtype):
    return (jnp.asarray(x).astype(JDT[dtype]),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _state_close(got, want, dtype):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32
        assert_close(got[k].numpy(), want[k], dtype)


@pytest.mark.parametrize("name", CONFIGS)
def test_rglru_block_apply_matches_jitted_reference(name):
    cj, _, ct, _ = models(name)
    lj, lt = layer(name, 0)
    xj, xt = _both(_np((B, 12, cj.d_model), 11), cj.dtype)
    yj = jax.jit(lambda p, x: jrg.rglru_block_apply(p, x, cj))(lj, xj)
    yt = trg.rglru_block_apply(lt, xt, ct)
    assert yt.dtype == ct.compute_dtype()
    assert_close(yt.float().numpy(), yj.astype(jnp.float32), cj.dtype)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("s", [12, 2])
def test_rglru_block_prefill_matches_jitted_reference(name, s):
    """A prompt of 12 tokens, and one shorter than the conv's carry (2):
    the output and the state after the last step (h, and the last inputs
    of the conv)."""
    cj, _, ct, _ = models(name)
    lj, lt = layer(name, 1)
    xj, xt = _both(_np((B, s, cj.d_model), 13), cj.dtype)
    cache_j = jlm.init_cache(cj, B, 8)[1]
    cache_t = tlm.init_cache(ct, B, 8, "cpu")[1]
    yj, sj = jax.jit(lambda p, x, c: jrg.rglru_block_prefill(
        p, x, cj, cache=c))(lj, xj, cache_j)
    yt, st = trg.rglru_block_prefill(lt, xt, ct, cache=cache_t)
    assert_close(yt.float().numpy(), yj.astype(jnp.float32), cj.dtype)
    _state_close(st, sj, cj.dtype)


@pytest.mark.parametrize("name", CONFIGS)
def test_rglru_block_decode_matches_jitted_reference(name):
    """Three steps from a random carry; the input cache is not
    modified."""
    cj, _, ct, _ = models(name)
    lj, lt = layer(name, 0)
    r, cw = cj.rnn_width, cj.conv_width
    cache_j = {"h": jnp.asarray(_np((B, r), 15)),
               "conv": jnp.asarray(_np((B, cw - 1, r), 16))}
    cache_t = {k: torch.from_numpy(np.array(v)) for k, v in cache_j.items()}
    before = {k: v.clone() for k, v in cache_t.items()}
    step = jax.jit(lambda p, x, c: jrg.rglru_block_decode(p, x, cj, cache=c))
    for i in range(3):
        xj, xt = _both(_np((B, 1, cj.d_model), 17 + i), cj.dtype)
        yj, cache_j = step(lj, xj, cache_j)
        yt, new_t = trg.rglru_block_decode(lt, xt, ct, cache=cache_t)
        if i == 0:
            assert all(torch.equal(cache_t[k], before[k]) for k in before)
        cache_t = new_t
        assert_close(yt.float().numpy(), yj.astype(jnp.float32), cj.dtype)
        _state_close(cache_t, cache_j, cj.dtype)


def _ring_cache(cj, ct, t_cache, seed):
    shape = (B, t_cache, cj.n_kv_heads, cj.head_dim)
    kj, kt = _both(_np(shape, seed), cj.dtype)
    vj, vt = _both(_np(shape, seed + 1), cj.dtype)
    return {"k": kj, "v": vj}, {"k": kt, "v": vt}


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("t_cache", [24, 9])
def test_local_attn_block_prefill_matches_jitted_reference(name, t_cache):
    """A 20-token prompt into a 24-slot cache (written at the front) and
    into a 9-slot ring (the trailing 9 rolled into place); the tiny
    config's window (16) masks inside the prompt."""
    cj, _, ct, _ = models(name)
    lj, lt = layer(name, 2)
    s = 20
    xj, xt = _both(_np((B, s, cj.d_model), 19), cj.dtype)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s))
    shape = (B, t_cache, cj.n_kv_heads, cj.head_dim)
    cache_j = {k: jnp.zeros(shape, JDT[cj.dtype]) for k in ("k", "v")}
    cache_t = {k: torch.zeros(shape, dtype=ct.compute_dtype())
               for k in ("k", "v")}
    yj, nj = jax.jit(lambda p, x, c: jlayers.attn_block_prefill(
        p, x, cj, local=True, positions=jnp.asarray(pos), cache=c))(
        lj, xj, cache_j)
    yt, nt = tlayers.attn_block_prefill(
        lt, xt, ct, local=True, positions=torch.from_numpy(pos.copy()),
        cache=cache_t)
    assert_close(yt.float().numpy(), yj.astype(jnp.float32), cj.dtype)
    for k in ("k", "v"):
        assert nt[k].dtype == ct.compute_dtype()
        assert_close(nt[k].float().numpy(), nj[k].astype(jnp.float32),
                     cj.dtype)
    yt = tlayers.attn_block_apply(lt, xt, ct, local=True,
                                  positions=torch.from_numpy(pos.copy()))
    assert_close(yt.float().numpy(), yj.astype(jnp.float32), cj.dtype)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("length", [5, 15, 16, 17, 40])
def test_local_attn_block_decode_matches_jitted_reference(name, length):
    """One token at position ``length`` against a random ring of
    ``window + 1`` = 17 slots (the tiny config's; the full width's window
    of 2048 leaves all 17 valid once it wraps): before the ring fills,
    as the window starts to drop a slot (16, 17) and after (40), where
    the valid slots are a run that does not start at slot 0."""
    cj, _, ct, _ = models(name)
    lj, lt = layer(name, 2)
    t_cache = min(17, cj.local_window + 1)
    cache_j, cache_t = _ring_cache(cj, ct, t_cache, 21)
    xj, xt = _both(_np((B, 1, cj.d_model), 23), cj.dtype)
    lens = np.full((B,), length, np.int32)
    yj, nj = jax.jit(lambda p, x, c, l: jlayers.attn_block_decode(
        p, x, cj, local=True, positions=l[:, None], cache=c, lengths=l))(
        lj, xj, cache_j, jnp.asarray(lens))
    ln = torch.from_numpy(lens)
    yt, nt = tlayers.attn_block_decode(
        lt, xt, ct, local=True, positions=ln[:, None], cache=cache_t,
        lengths=ln)
    assert_close(yt.float().numpy(), yj.astype(jnp.float32), cj.dtype)
    for k in ("k", "v"):
        assert_close(nt[k].float().numpy(), nj[k].astype(jnp.float32),
                     cj.dtype)


@pytest.mark.parametrize("name", CONFIGS + ["full"])
def test_schema_matches_reference(name):
    if name == "full":
        cj, ct = jreg.get(ARCH)[0], treg.get(ARCH)[0]
    else:
        cj, ct = configs(name)
    flat = lambda tree: {
        jax.tree_util.keystr(path): (tuple(ps.shape), tuple(ps.axes),
                                     tuple(ps.init))
        for path, ps in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    assert flat(tlm.build_schema(ct)) == flat(jlm.build_schema(cj))
    for t_cache in (512, 17):
        assert flat(tlm.cache_schema(ct, 8, t_cache)) == \
            flat(jlm.cache_schema(cj, 8, t_cache))


def test_full_config_has_the_published_size():
    """recurrentgemma-2b at full width: 2,658,736,640 parameters counted
    from the port's schema (the count of the JAX package's abstract
    params), 78,673,920 in each RG-LRU block and 73,405,440 in each local
    attention block; bf16 compute, f32 at rest; the configs equal the JAX
    package's field for field."""
    cfg = treg.get(ARCH)[0]
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        jlm.abstract_params(jreg.get(ARCH)[0])))
    assert tlm.n_params(cfg) == want == 2_658_736_640
    count = lambda sch: sum(int(np.prod(ps.shape)) for ps in
                            jax.tree_util.tree_leaves(
                                sch, is_leaf=lambda x: hasattr(x, "axes")))
    assert count(trg.rglru_schema(cfg)) == 78_673_920
    assert count(tlayers.attn_schema(cfg, local=True)) == 73_405_440
    assert cfg.blocks().count("rglru") == 18
    assert cfg.blocks().count("local_attn") == 8
    assert cfg.compute_dtype() == torch.bfloat16
    assert cfg.param_dtype == "float32"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jreg.get(ARCH)[0])
    assert dataclasses.asdict(treg.get_tiny(ARCH)) == \
        dataclasses.asdict(jreg.get_tiny(ARCH))
    assert treg.get(ARCH)[1].source == jreg.get(ARCH)[1].source
