"""The port's two modality frontends (plain path, CPU) against the JAX
package's, compiled (``jax.jit``), with the JAX parameters carried across
by ``params_from_reference``: llava-next-mistral-7b (``vision_stub``:
patch embeddings put before the token embeddings) and hubert-xlarge
(``audio_stub``: frame embeddings in, no ``embed`` leaf, bidirectional,
encoder-only).

Each tiny config's schema (leaf names and shapes, the full configs' too),
``lm.forward`` and ``lm.prefill`` in f32 and bf16, llava-tiny's prefill of
more patches than its config's 8 then 6 decode steps, hubert's decode step
taking its input as is (the reference's pass-through), a one-layer cut of
hubert-xlarge at its full width (16 heads of 80) in bf16, the full
configs' parameter counts, and the entry points: both serve CLIs fail as
the reference's do, and the trainer refuses both.  Inputs are numpy
normals and integers from a seed, handed to both packages.  Tolerances:
f32 within 1e-4 (absolute and relative); bf16 within 3 % of the
reference's largest magnitude (``tests/test_torch_xlstm.py::
assert_close``: the port does attention's P.V in f32 where the JAX model
first rounds the probabilities to bf16)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.models.layers import PSpec as JPSpec
from repro_torch.configs import registry as treg
from repro_torch.launch import serve, train
from repro_torch.models import lm as tlm
from repro_torch.models.layers import PSpec
from test_torch_xlstm import assert_close

LLAVA, HUBERT = "llava-next-mistral-7b", "hubert-xlarge"
N_PARAMS = {LLAVA: 7_241_732_096, HUBERT: 944_487_680}
B = 2


def configs(arch, name):
    """(JAX config, port config): the tiny config in f32 (``tiny``) or
    bf16 (``tiny-bf16``), or hubert-xlarge cut to one layer at its full
    width (``layer``, bf16 as published)."""
    if name == "layer":
        return tuple(dataclasses.replace(reg.get(arch)[0], n_layers=1)
                     for reg in (jreg, treg))
    cj, ct = jreg.get_tiny(arch), treg.get_tiny(arch)
    if name == "tiny-bf16":
        cj, ct = (dataclasses.replace(c, dtype="bfloat16") for c in (cj, ct))
    return cj, ct


@functools.lru_cache(maxsize=None)
def models(arch, name):
    """JAX config + params, port config + Model (same weights)."""
    cj, ct = configs(arch, name)
    pj = jlm.init_params(cj, 0)
    pt = tlm.params_from_reference(ct, jax.tree.map(np.asarray, pj), "cpu")
    return cj, pj, ct, pt


def _batch(cfg, s, seed, patches=None):
    """(JAX batch, port batch) of ``s`` positions: ``frames`` for hubert;
    for llava ``patches`` patch embeddings (the config's count unless
    given) and ``s`` - that many tokens."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        f = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
        return {"frames": jnp.asarray(f)}, {"frames": torch.from_numpy(f)}
    p = cfg.n_patches if patches is None else patches
    pe = rng.standard_normal((B, p, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, s - p)).astype(np.int32)
    return ({"patch_embeds": jnp.asarray(pe), "tokens": jnp.asarray(toks)},
            {"patch_embeds": torch.from_numpy(pe),
             "tokens": torch.from_numpy(toks).long()})


def _leaves(schema, is_spec, path=()):
    """{path: shape} of a schema's leaves."""
    if is_spec(schema):
        return {"/".join(map(str, path)): tuple(schema.shape)}
    items = schema.items() if isinstance(schema, dict) else \
        enumerate(schema)
    out = {}
    for k, v in items:
        out.update(_leaves(v, is_spec, path + (k,)))
    return out


@pytest.mark.parametrize("arch", [LLAVA, HUBERT])
@pytest.mark.parametrize("full", [False, True])
def test_schema_leaves_match_the_reference(arch, full):
    """Leaf names and shapes; hubert has no ``embed`` and always an
    ``unembed``, llava both (untied)."""
    cj, ct = (reg.get(arch)[0] if full else reg.get_tiny(arch)
              for reg in (jreg, treg))
    want = _leaves(jlm.build_schema(cj), lambda x: isinstance(x, JPSpec))
    got = _leaves(tlm.build_schema(ct), lambda x: isinstance(x, PSpec))
    assert got == want
    assert ("embed" in got) == (arch == LLAVA) and "unembed" in got


@pytest.mark.parametrize("arch", [LLAVA, HUBERT])
@pytest.mark.parametrize("name", ["tiny", "tiny-bf16"])
def test_forward_matches_jitted_reference(arch, name):
    cj, pj, ct, pt = models(arch, name)
    bj, bt = _batch(cj, 20, seed=31)
    want = jax.jit(lambda p, b: jlm.forward(p, cj, b))(pj, bj)
    got = tlm.forward(pt, ct, bt)
    assert got.shape == (B, 20, ct.vocab) and got.dtype == torch.float32
    assert_close(got.numpy(), want, cj.dtype)


@pytest.mark.parametrize("arch", [LLAVA, HUBERT])
@pytest.mark.parametrize("name", ["tiny", "tiny-bf16"])
def test_prefill_matches_jitted_reference(arch, name):
    """The last position's logits and the filled 32-slot cache."""
    cj, pj, ct, pt = models(arch, name)
    bj, bt = _batch(cj, 20, seed=32)
    lj, cache_j = jax.jit(lambda p, b, c: jlm.prefill(p, cj, b, c))(
        pj, bj, jlm.init_cache(cj, B, 32))
    lt, cache_t = tlm.prefill(pt, ct, bt, tlm.init_cache(ct, B, 32, "cpu"))
    assert lt.shape == (B, 1, ct.vocab) and lt.dtype == torch.float32
    assert_close(lt.numpy(), lj, cj.dtype)
    got = tlm.cache_to_reference(cache_t)
    for k in "kv":
        w = np.asarray(cache_j[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape
        assert_close(got[k].astype(np.float32), w.astype(np.float32),
                     cj.dtype)


@pytest.mark.parametrize("name", ["tiny", "tiny-bf16"])
def test_llava_prefill_of_more_patches_then_6_decode_steps(name):
    """24 patch embeddings (the tiny config says 8; a batch may carry any
    number) and 6 tokens into a 40-slot cache, then 6 decode steps at
    positions 30-35; the cache carried back at the end."""
    cj, pj, ct, pt = models(LLAVA, name)
    bj, bt = _batch(cj, 30, seed=33, patches=24)
    pre = jax.jit(lambda p, b, c: jlm.prefill(p, cj, b, c))
    dec = jax.jit(lambda p, t, l, c: jlm.decode_step(p, cj, t, l, c))
    lj, cache_j = pre(pj, bj, jlm.init_cache(cj, B, 40))
    lt, cache_t = tlm.prefill(pt, ct, bt, tlm.init_cache(ct, B, 40, "cpu"))
    assert_close(lt.numpy(), lj, cj.dtype)
    len_j = jnp.full((B,), 30, jnp.int32)
    len_t = torch.full((B,), 30, dtype=torch.int32)
    rng = np.random.default_rng(34)
    for _ in range(6):
        tk = rng.integers(0, cj.vocab, (B, 1)).astype(np.int32)
        lj, cache_j, len_j = dec(pj, jnp.asarray(tk), len_j, cache_j)
        lt, cache_t, len_t = tlm.decode_step(
            pt, ct, torch.from_numpy(tk).long(), len_t, cache_t)
        assert_close(lt.numpy(), lj, cj.dtype)
    assert len_t.tolist() == [36] * B
    got = tlm.cache_to_reference(cache_t)
    for k in "kv":
        assert_close(got[k], np.asarray(cache_j[k]), cj.dtype)


def test_hubert_decode_step_takes_its_input_as_is():
    """The reference's ``decode_step`` passes an ``audio_stub`` model's
    ``tokens`` through as the layer-0 input (a [B, 1, d_model] frame; no
    embedding to look up): one step after a 12-frame prefill."""
    cj, pj, ct, pt = models(HUBERT, "tiny")
    bj, bt = _batch(cj, 12, seed=35)
    _, cache_j = jax.jit(lambda p, b, c: jlm.prefill(p, cj, b, c))(
        pj, bj, jlm.init_cache(cj, B, 16))
    _, cache_t = tlm.prefill(pt, ct, bt, tlm.init_cache(ct, B, 16, "cpu"))
    x = np.random.default_rng(36).standard_normal(
        (B, 1, cj.d_model)).astype(np.float32)
    lj, _, _ = jax.jit(lambda p, t, l, c: jlm.decode_step(p, cj, t, l, c))(
        pj, jnp.asarray(x), jnp.full((B,), 12, jnp.int32), cache_j)
    lt, _, lens = tlm.decode_step(pt, ct, torch.from_numpy(x),
                                  torch.full((B,), 12, dtype=torch.int32),
                                  cache_t)
    assert lens.tolist() == [13] * B
    assert_close(lt.numpy(), lj, cj.dtype)


def test_hubert_layer_at_full_width_bf16():
    """hubert-xlarge's widths (d_model 1280, 16 heads of 80, GELU d_ff
    5120, 504 units) cut to one layer, bf16: ``forward`` of 50 frames,
    bidirectional."""
    cj, pj, ct, pt = models(HUBERT, "layer")
    assert (ct.head_dim, ct.n_heads, ct.causal, ct.dtype) == \
        (80, 16, False, "bfloat16")
    bj, bt = _batch(cj, 50, seed=37)
    want = jax.jit(lambda p, b: jlm.forward(p, cj, b))(pj, bj)
    got = tlm.forward(pt, ct, bt)
    assert got.shape == (B, 50, 504)
    assert_close(got.numpy(), want, cj.dtype)


@pytest.mark.parametrize("arch", [LLAVA, HUBERT])
def test_full_config_parameter_count_and_registry(arch):
    """The full configs' parameters, counted from the schema without
    building a weight, as the reference's abstract parameters count; the
    config's fields and META are the reference's."""
    cj, meta_j = jreg.get(arch)
    ct, meta_t = treg.get(arch)
    assert tlm.n_params(ct) == N_PARAMS[arch]
    assert sum(int(np.prod(a.shape)) for a in
               jax.tree.leaves(jlm.abstract_params(cj))) == N_PARAMS[arch]
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert dataclasses.asdict(treg.get_tiny(arch)) == \
        dataclasses.asdict(jreg.get_tiny(arch))
    assert (meta_t.source, meta_t.train_microbatches) == \
        (meta_j.source, meta_j.train_microbatches)
    assert arch.replace("-", "_") in treg.PORTED
    assert sorted(treg.PORTED) == sorted(jreg.ARCHS)


def test_params_from_reference_takes_a_tree_without_embed():
    """hubert's tree has no ``embed``: every leaf the schema names is
    carried across, and the Model holds no embedding."""
    cj, pj, ct, pt = models(HUBERT, "tiny")
    assert "embed" not in pj
    names = dict(pt.named_parameters())
    assert "embed" not in names and "unembed" in names
    assert np.array_equal(names["unembed"].numpy(), np.asarray(pj["unembed"]))
    assert np.array_equal(names["layers.wq"].numpy(),
                          np.asarray(pj["layers"]["wq"]))


def test_serve_cli_fails_as_the_reference_and_training_is_refused():
    """hubert is encoder-only: both serve CLIs exit with that message.
    llava's calibration feeds tokens only: both fail on the missing
    ``patch_embeds``.  The trainer refuses both (its data source yields
    tokens only)."""
    for main in (jserve.main,
                 lambda argv: serve.main(argv, device="cpu")):
        with pytest.raises(SystemExit, match="encoder-only"):
            main(["--arch", HUBERT, "--tiny"])
        with pytest.raises(KeyError, match="patch_embeds"):
            main(["--arch", LLAVA, "--tiny", "--duration", "1"])
    for arch, frontend in ((LLAVA, "vision_stub"), (HUBERT, "audio_stub")):
        with pytest.raises(NotImplementedError, match=frontend):
            train.main(["--arch", arch, "--tiny", "--steps", "1"],
                       device="cpu")
