"""The port's yi-6b model (plain path, CPU) against the JAX package's,
compiled (``jax.jit``), with the JAX parameters carried across by
``params_from_reference``: the attention block's apply, prefill (with and
without the ring roll) and decode (before and after the ring wraps),
``lm.prefill`` then four ``lm.decode_step``s through a ring wrap,
``lm.forward``, the caches carried across both ways, RoPE, the decode
mask, the schema and the parameter count.  Three configs: yi-6b-tiny in
f32 (a scanned stack of 2 layers), yi-6b-tiny in bf16, and yi-6b's full
width (d_model 4096, 32 / 4 heads of 128, d_ff 11008, bf16) cut to 1
layer and a vocab of 512.

Inputs are made with numpy from a seed.  Tolerances, in the compute
dtype: f32 within 1e-4 (absolute and relative; the two sides' sin, cos
and pow differ in ulps, and the port divides scores by sqrt(dh) where
XLA may multiply); bf16 within 3% of the reference's largest magnitude
(max abs difference), as ``tests/test_torch_xlstm.py`` states: on top of
that file's reasons, the port does P.V in f32 (the kernels' semantics)
where the JAX model first rounds the probabilities to bf16."""

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
from repro_torch.launch import train as ttrain
from repro_torch.kernels.ref import decode_attention_ref, \
    flash_attention_ref
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from test_torch_xlstm import assert_close

CONFIGS = ["tiny-f32", "tiny-bf16", "wide-1l"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
B = 2


def configs(name):
    """(JAX config, port config) of one test config."""
    if name == "tiny-f32":
        return jreg.get_tiny("yi-6b"), treg.get_tiny("yi-6b")
    if name == "tiny-bf16":
        return tuple(dataclasses.replace(c, dtype="bfloat16") for c in
                     (jreg.get_tiny("yi-6b"), treg.get_tiny("yi-6b")))
    kw = dict(n_layers=1, vocab=512)
    return (dataclasses.replace(jreg.get("yi-6b")[0], **kw),
            dataclasses.replace(treg.get("yi-6b")[0], **kw))


@functools.lru_cache(maxsize=None)
def models(name):
    """JAX config + params, port config + Model (same weights)."""
    cj, ct = configs(name)
    pj = jlm.init_params(cj, 0)
    pt = tlm.params_from_reference(ct, jax.tree.map(np.asarray, pj), "cpu")
    return cj, pj, ct, pt


def layer0(name):
    """(JAX, port) parameters of the first layer."""
    cj, pj, ct, pt = models(name)
    if "layers" in pj:
        return (jax.tree.map(lambda a: a[0], pj["layers"]),
                tlm._layers(pt.tree(), ct)[0][1])
    return pj["blocks"][0], pt.tree()["blocks"][0]


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(x, dtype):
    return (jnp.asarray(x).astype(JDT[dtype]),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _cache_close(got, want, dtype):
    for k in ("k", "v"):
        assert got[k].dtype == getattr(torch, dtype)
        assert_close(got[k].float().numpy(), want[k].astype(jnp.float32),
                     dtype)


@pytest.mark.parametrize("name", CONFIGS)
def test_attn_block_apply_matches_jitted_reference(name):
    cj, _, ct, _ = models(name)
    lj, lt = layer0(name)
    xj, xt = _both(_np((B, 12, cj.d_model), 11), cj.dtype)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (B, 12))
    yj = jax.jit(lambda p, x: jlayers.attn_block_apply(
        p, x, cj, local=False, positions=jnp.asarray(pos)))(lj, xj)
    yt = tlayers.attn_block_apply(lt, xt, ct, local=False,
                                  positions=torch.from_numpy(pos.copy()))
    assert yt.dtype == ct.compute_dtype()
    assert_close(yt.float().numpy(), yj.astype(jnp.float32), cj.dtype)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("t_cache", [16, 8])
def test_attn_block_prefill_matches_jitted_reference(name, t_cache):
    """A 12-token prompt into a 16-slot cache (written at the front) and
    into an 8-slot ring (the trailing 8 rolled into place)."""
    cj, _, ct, _ = models(name)
    lj, lt = layer0(name)
    xj, xt = _both(_np((B, 12, cj.d_model), 13), cj.dtype)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (B, 12))
    shape = (B, t_cache, cj.n_kv_heads, cj.head_dim)
    cache_j = {k: jnp.zeros(shape, JDT[cj.dtype]) for k in ("k", "v")}
    cache_t = {k: torch.zeros(shape, dtype=ct.compute_dtype())
               for k in ("k", "v")}
    yj, nj = jax.jit(lambda p, x, c: jlayers.attn_block_prefill(
        p, x, cj, local=False, positions=jnp.asarray(pos), cache=c))(
        lj, xj, cache_j)
    yt, nt = tlayers.attn_block_prefill(
        lt, xt, ct, local=False, positions=torch.from_numpy(pos.copy()),
        cache=cache_t)
    assert_close(yt.float().numpy(), yj.astype(jnp.float32), cj.dtype)
    _cache_close(nt, nj, cj.dtype)
    assert not cache_t["k"].any()              # the input is not modified


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("length", [5, 15, 16, 37])
def test_attn_block_decode_matches_jitted_reference(name, length):
    """One token at position ``length`` against a random 16-slot cache:
    before the ring fills (5, 15), as it wraps (16) and after (37)."""
    cj, _, ct, _ = models(name)
    lj, lt = layer0(name)
    t_cache = 16
    xj, xt = _both(_np((B, 1, cj.d_model), 17), cj.dtype)
    shape = (B, t_cache, cj.n_kv_heads, cj.head_dim)
    kj, kt = _both(_np(shape, 18), cj.dtype)
    vj, vt = _both(_np(shape, 19), cj.dtype)
    lens = np.full((B,), length, np.int32)
    yj, nj = jax.jit(lambda p, x, c, l: jlayers.attn_block_decode(
        p, x, cj, local=False, positions=l[:, None], cache=c, lengths=l))(
        lj, xj, {"k": kj, "v": vj}, jnp.asarray(lens))
    ln = torch.from_numpy(lens)
    yt, nt = tlayers.attn_block_decode(
        lt, xt, ct, local=False, positions=ln[:, None],
        cache={"k": kt, "v": vt}, lengths=ln)
    assert_close(yt.float().numpy(), yj.astype(jnp.float32), cj.dtype)
    _cache_close(nt, nj, cj.dtype)


@pytest.mark.parametrize("last", [0, 3, 15, 16, 17, 40])
def test_decode_mask_is_the_prefix_the_kernel_takes(last):
    """The reference's position-aware mask of a full-attention block, on
    both sides of the ring's wrap, is the prefix of min(last + 1, T)
    slots: the count the port passes to decode_attention."""
    t = 16
    want = np.asarray(jlayers.cache_slot_positions(jnp.int32(last), t))
    got = tlayers.cache_slot_positions(torch.tensor(last), t).numpy()
    assert got.tolist() == want.tolist()
    valid = (want >= 0) & (want <= last)
    n = min(last + 1, t)
    assert valid.tolist() == [True] * n + [False] * (t - n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    xj, xt = _both(_np((2, 9, 4, 16), 23), dtype)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    want = jax.jit(lambda x, p: jlayers.rope(x, p, 5e6))(xj, jnp.asarray(pos))
    got = tlayers.rope(xt, torch.from_numpy(pos), 5e6)
    assert got.dtype == xt.dtype
    assert_close(got.float().numpy(), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("t_cache", [32, 8])
def test_prefill_then_decode_matches_jitted_reference(name, t_cache):
    """A 10-token prompt, then 4 decode steps: into a 32-slot cache, and
    through an 8-slot ring (the prompt fills it; the steps wrap it)."""
    cj, pj, ct, pt = models(name)
    s, n_decode = 10, 4
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
    want = jax.tree.map(np.asarray, cache_j)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert_close(g.astype(np.float32), w.astype(np.float32), cj.dtype)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_jitted_reference(name):
    cj, pj, ct, pt = models(name)
    toks = _tokens(cj.vocab, (B, 12), seed=22)
    want = jax.jit(lambda p, b: jlm.forward(p, cj, b))(
        pj, {"tokens": jnp.asarray(toks)})
    got = tlm.forward(pt, ct, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (B, 12, ct.vocab)
    assert_close(got.numpy(), want, cj.dtype)


@pytest.mark.parametrize("name", CONFIGS)
def test_cache_round_trips_and_decodes_as_the_reference(name):
    """A cache the JAX package filled (the scanned stack's one dict of
    stacked leaves, or the per-layer list) comes across and back bit for
    bit, in its dtype, and decodes to the JAX package's logits; an
    initial cache matches the reference's leaf for leaf."""
    cj, pj, ct, pt = models(name)
    toks = _tokens(cj.vocab, (B, 9), seed=23)
    _, cache_j = jax.jit(lambda p, b, c: jlm.prefill(p, cj, b, c))(
        pj, {"tokens": jnp.asarray(toks)}, jlm.init_cache(cj, B, 16))
    np_cache = jax.tree.map(np.asarray, cache_j)
    cache_t = tlm.cache_from_reference(np_cache, "cpu")
    back = tlm.cache_to_reference(cache_t)
    assert jax.tree.structure(back) == jax.tree.structure(np_cache)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(np_cache)):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    tk = _tokens(cj.vocab, (B, 1), seed=24)
    lens = np.full((B,), 9, np.int32)
    lj, _, _ = jax.jit(lambda p, t, l, c: jlm.decode_step(p, cj, t, l, c))(
        pj, jnp.asarray(tk), jnp.asarray(lens), cache_j)
    lt, _, _ = tlm.decode_step(pt, ct, torch.from_numpy(tk).long(),
                               torch.from_numpy(lens), cache_t)
    assert_close(lt.numpy(), lj, cj.dtype)
    init_j = jax.tree.map(np.asarray, jlm.init_cache(cj, 3, 16))
    init_t = tlm.cache_to_reference(tlm.init_cache(ct, 3, 16, "cpu"))
    assert jax.tree.structure(init_t) == jax.tree.structure(init_j)
    for g, w in zip(jax.tree.leaves(init_t), jax.tree.leaves(init_j)):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_params_from_reference_keeps_the_scanned_tree():
    """yi-6b-tiny is a scanned stack: every leaf under ``layers.`` with a
    leading n_layers axis, named and valued as the JAX tree, and each
    layer's parameters are views of the stacked leaves."""
    _, pj, ct, pt = models("tiny-f32")
    flat = {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(pj)[0]}
    got = dict(pt.named_parameters())
    assert set(got) == set(flat)
    assert {"layers.wq", "layers.mlp.wi", "embed"} <= set(got)
    for k, v in flat.items():
        assert got[k].dtype == torch.float32
        assert got[k].numpy().tobytes() == v.astype(np.float32).tobytes()
    assert got["layers.wq"].shape[0] == ct.n_layers == 2
    lp = tlm._layers(pt.tree(), ct)[1][1]
    assert lp["mlp"]["wi"].data_ptr() == got["layers.mlp.wi"][1].data_ptr()


@pytest.mark.parametrize("name", CONFIGS + ["full"])
def test_schema_matches_reference(name):
    if name == "full":
        cj, ct = jreg.get("yi-6b")[0], treg.get("yi-6b")[0]
    else:
        cj, ct = configs(name)
    flat = lambda tree: {
        jax.tree_util.keystr(path): (tuple(ps.shape), tuple(ps.axes),
                                     tuple(ps.init))
        for path, ps in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    assert flat(tlm.build_schema(ct)) == flat(jlm.build_schema(cj))
    assert flat(tlm.cache_schema(ct, 8, 512)) == \
        flat(jlm.cache_schema(cj, 8, 512))


def test_full_config_has_the_published_size():
    """yi-6b at full width: 6,061,035,520 parameters counted from the
    port's schema (the count of the JAX package's abstract params), bf16
    compute, f32 at rest."""
    cfg = treg.get("yi-6b")[0]
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        jlm.abstract_params(jreg.get("yi-6b")[0])))
    assert tlm.n_params(cfg) == want == 6_061_035_520
    assert cfg.compute_dtype() == torch.bfloat16
    assert cfg.param_dtype == "float32"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jreg.get("yi-6b")[0])
    assert dataclasses.asdict(treg.get_tiny("yi-6b")) == \
        dataclasses.asdict(jreg.get_tiny("yi-6b"))


def test_explicit_plain_kernels_are_the_cpu_path():
    """On the CPU the kernels' wrappers run the plain versions, so passing
    them explicitly (as chip_smoke.py does on the card) changes nothing."""
    _, _, ct, pt = models("tiny-bf16")
    toks = torch.from_numpy(_tokens(ct.vocab, (B, 10), seed=25)).long()
    plain = dict(flash_attention=flash_attention_ref,
                 decode_attention=decode_attention_ref)
    runs = []
    for kw in ({}, plain):
        lo, cache = tlm.prefill(pt, ct, {"tokens": toks},
                                tlm.init_cache(ct, B, 8, "cpu"), **kw)
        lens = torch.full((B,), 10, dtype=torch.int32)
        ld, cache, _ = tlm.decode_step(pt, ct, toks[:, :1], lens, cache,
                                       **kw)
        runs.append((lo, ld, cache))
    (a, b, c), (x, y, z) = runs
    assert torch.equal(a, x) and torch.equal(b, y)
    assert all(torch.equal(c[k], z[k]) for k in c)
    with pytest.raises(TypeError, match="flash_attn"):
        tlm.forward(pt, ct, {"tokens": toks}, flash_attn=None)


def test_what_is_not_ported_raises():
    """The two frontends build; an unknown frontend, an unknown arch and
    training a frontend config are still refused."""
    cfg = treg.get_tiny("yi-6b")
    for frontend in ("vision_stub", "audio_stub"):
        sch = tlm.build_schema(dataclasses.replace(cfg, frontend=frontend))
        assert ("embed" in sch) == (frontend == "vision_stub")
    with pytest.raises(KeyError, match="image_tower"):
        tlm.init_cache(dataclasses.replace(cfg, frontend="image_tower"), 1,
                       8, "cpu")
    assert treg.get("hubert-xlarge")[0].frontend == "audio_stub"
    with pytest.raises(KeyError, match="hubert-large"):
        treg.get("hubert-large")
    with pytest.raises(NotImplementedError, match="audio_stub"):
        ttrain.main(["--arch", "hubert-xlarge", "--tiny"], device="cpu")
    # The mixture of experts is ported: the reference's "moe" subtree.
    moe = dataclasses.replace(cfg, n_experts=4, top_k=2)
    sch = tlayers.attn_schema(moe, local=True)
    assert "mlp" not in sch and sorted(sch["moe"]) == ["router", "w1", "w2",
                                                       "wg"]
    want = jlayers.attn_schema(dataclasses.replace(
        jreg.get_tiny("yi-6b"), n_experts=4, top_k=2), local=True)["moe"]
    assert {k: (v.shape, v.axes, v.init) for k, v in sch["moe"].items()} \
        == {k: (v.shape, v.axes, v.init) for k, v in want.items()}
    assert sch["moe"]["w1"].shape == (4, cfg.d_model, cfg.d_ff)
    assert "moe" in tlm.build_schema(moe)["layers"]
