"""The port's phi3.5-moe, grok-1, llama3-405b and qwen1.5-110b (plain
path, CPU) against the JAX package's, compiled (``jax.jit``), with the
JAX parameters carried across by ``params_from_reference``: the attention
block's apply, prefill and decode (its FFN the mixture of experts for the
first two), ``lm.forward``, and ``lm.prefill`` then 6 ``lm.decode_step``s
of each tiny config (f32; grok-1's with its tanh logit soft-cap, qwen's
with QKV bias and head dim 8, llama3's with rope_theta 500,000).  Also
each full config's parameter count from the schema (no weight built)
against the reference's, the registry, the sliced draw of a large bf16
leaf, and the trainer refusing a mixture-of-experts config.

Parameters and inputs are made with numpy from a seed.  Tolerance: f32
within 1e-4 (absolute and relative;
``tests/test_torch_xlstm.py::assert_close``)."""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import registry as treg
from repro_torch.launch import train
from repro_torch.models import layers as tlayers
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from test_torch_xlstm import assert_close

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

ARCHS = ["phi35-moe-42b", "grok-1-314b", "llama3-405b", "qwen15-110b"]
N_PARAMS = {"phi35-moe-42b": 41_872_527_360,
            "grok-1-314b": 316_489_340_928,
            "llama3-405b": 405_853_388_800,
            "qwen15-110b": 111_209_914_368}
B = 2


def _np_params(cj, seed):
    """The reference's parameter tree drawn with numpy: each leaf normal
    at its schema's scale, and the leaves the schema starts at zero (norm
    scales, QKV biases) normal at 0.1, so that they count."""
    leaves, treedef = jax.tree.flatten(
        jlm.build_schema(cj), is_leaf=lambda x: isinstance(x, jlayers.PSpec))
    rng = np.random.default_rng(seed)
    scale = {"normal": lambda ps: ps.init[1], "zeros": lambda ps: 0.1}
    return jax.tree.unflatten(treedef, [
        (rng.standard_normal(ps.shape) * scale[ps.init[0]](ps))
        .astype(np.float32) for ps in leaves])


@functools.lru_cache(maxsize=None)
def models(arch):
    """JAX config + params, port config + Model (same weights)."""
    cj, ct = jreg.get_tiny(arch), treg.get_tiny(arch)
    pn = _np_params(cj, 0)
    pt = tlm.params_from_reference(ct, pn, "cpu")
    return cj, jax.tree.map(jnp.asarray, pn), ct, pt


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _layer(arch, i):
    _, pj, _, pt = models(arch)
    return (jax.tree.map(lambda v: v[i], pj["layers"]),
            tlm._layer(pt.tree()["layers"], i))


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_block_apply_and_prefill_match_jitted_reference(arch):
    """A 12-token prompt into a 16-slot cache: the block's output and
    the filled cache; apply gives prefill's output."""
    cj, _, ct, _ = models(arch)
    lj, lt = _layer(arch, 1)
    assert ("moe" in lt) == bool(ct.n_experts) and ("mlp" in lt) != \
        bool(ct.n_experts)
    s, t_cache = 12, 16
    xj, xt = _x((B, s, cj.d_model), 11)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy()
    shape = (B, t_cache, cj.n_kv_heads, cj.head_dim)
    cache_j = {k: jnp.zeros(shape, jnp.float32) for k in "kv"}
    cache_t = {k: torch.zeros(shape) for k in "kv"}
    yj, nj = jax.jit(lambda p, x, c: jlayers.attn_block_prefill(
        p, x, cj, local=False, positions=jnp.asarray(pos), cache=c))(
        lj, xj, cache_j)
    yt, nt = tlayers.attn_block_prefill(lt, xt, ct, local=False,
                                        positions=torch.from_numpy(pos),
                                        cache=cache_t)
    assert_close(yt.numpy(), yj, cj.dtype)
    for k in "kv":
        assert_close(nt[k].numpy(), nj[k], cj.dtype)
    aj = jax.jit(lambda p, x: jlayers.attn_block_apply(
        p, x, cj, local=False, positions=jnp.asarray(pos)))(lj, xj)
    at = tlayers.attn_block_apply(lt, xt, ct, local=False,
                                  positions=torch.from_numpy(pos))
    assert torch.equal(at, yt)
    assert_close(at.numpy(), aj, cj.dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("length", [0, 15])
def test_attn_block_decode_matches_jitted_reference(arch, length):
    """One token at position ``length`` against a random 16-slot cache
    (the first ``length + 1`` slots valid; 15 fills it)."""
    cj, _, ct, _ = models(arch)
    lj, lt = _layer(arch, 0)
    shape = (B, 16, cj.n_kv_heads, cj.head_dim)
    rng = np.random.default_rng(21)
    kv = {k: rng.standard_normal(shape).astype(np.float32) for k in "kv"}
    xj, xt = _x((B, 1, cj.d_model), 23)
    lens = np.full((B,), length, np.int32)
    yj, nj = jax.jit(lambda p, x, c, l: jlayers.attn_block_decode(
        p, x, cj, local=False, positions=l[:, None], cache=c, lengths=l))(
        lj, xj, {k: jnp.asarray(v) for k, v in kv.items()},
        jnp.asarray(lens))
    lt_ = torch.from_numpy(lens)
    yt, nt = tlayers.attn_block_decode(
        lt, xt, ct, local=False, positions=lt_[:, None],
        cache={k: torch.from_numpy(v) for k, v in kv.items()}, lengths=lt_)
    assert_close(yt.numpy(), yj, cj.dtype)
    for k in "kv":
        assert_close(nt[k].numpy(), nj[k], cj.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jitted_reference(arch):
    cj, pj, ct, pt = models(arch)
    toks = _tokens(cj.vocab, (B, 20), seed=22)
    want = jax.jit(lambda p, b: jlm.forward(p, cj, b))(
        pj, {"tokens": jnp.asarray(toks)})
    got = tlm.forward(pt, ct, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (B, 20, ct.vocab) and got.dtype == torch.float32
    assert_close(got.numpy(), want, cj.dtype)
    if ct.logits_softcap:
        assert float(got.abs().max()) < ct.logits_softcap


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_6_decode_steps_match_jitted_reference(arch):
    """A 10-token prompt into a 16-slot cache, then 6 decode steps; the
    scanned stack's cache carried across to the reference at the end."""
    cj, pj, ct, pt = models(arch)
    s, n_decode, t_cache = 10, 6, 16
    toks = _tokens(cj.vocab, (B, s), seed=21)
    pre = jax.jit(lambda p, b, c: jlm.prefill(p, cj, b, c))
    dec = jax.jit(lambda p, t, l, c: jlm.decode_step(p, cj, t, l, c))
    lj, cache_j = pre(pj, {"tokens": jnp.asarray(toks)},
                      jlm.init_cache(cj, B, t_cache))
    lt, cache_t = tlm.prefill(pt, ct, {"tokens": torch.from_numpy(toks)
                                       .long()},
                              tlm.init_cache(ct, B, t_cache, "cpu"))
    assert lt.shape == (B, 1, ct.vocab)
    assert_close(lt.numpy(), lj, cj.dtype)
    len_j = jnp.full((B,), s, jnp.int32)
    len_t = torch.full((B,), s, dtype=torch.int32)
    for i in range(n_decode):
        tk = _tokens(cj.vocab, (B, 1), seed=30 + i)
        lj, cache_j, len_j = dec(pj, jnp.asarray(tk), len_j, cache_j)
        lt, cache_t, len_t = tlm.decode_step(
            pt, ct, torch.from_numpy(tk).long(), len_t, cache_t)
        assert_close(lt.numpy(), lj, cj.dtype)
    got = tlm.cache_to_reference(cache_t)
    for k in "kv":
        w = np.asarray(cache_j[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape
        assert_close(got[k], w, cj.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_count_and_registry(arch):
    """The full config's parameters, counted from the schema without
    building a weight, equal the reference's abstract parameters; the
    configs' fields and the metadata are the reference's."""
    cj, meta_j = jreg.get(arch)
    ct, meta_t = treg.get(arch)
    assert tlm.n_params(ct) == N_PARAMS[arch]
    ref = sum(int(np.prod(a.shape))
              for a in jax.tree.leaves(jlm.abstract_params(cj)))
    assert ref == N_PARAMS[arch]
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert dataclasses.asdict(treg.get_tiny(arch)) == \
        dataclasses.asdict(jreg.get_tiny(arch))
    assert meta_t == type(meta_t)(**dataclasses.asdict(meta_j))
    assert ct.param_dtype == "bfloat16"
    assert arch.replace("-", "_") in treg.PORTED
    # The schema's leaf shapes, path for path.
    want = jax.tree_util.tree_flatten_with_path(jlm.abstract_params(cj))[0]
    got = dict(tlm.Model(ct, lambda ps, _p: torch.empty(ps.shape,
                                                        device="meta"))
               .named_parameters())
    assert len(got) == len(want)
    for path, leaf in want:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        assert tuple(got[name].shape) == tuple(leaf.shape), name


def test_sliced_bf16_draw(monkeypatch):
    """A leaf that is not f32 at rest and is over ``DRAW_CHUNK`` elements
    is drawn slice by slice: its shape, its dtype and its scale; an f32
    leaf is still drawn whole (the same values as one ``torch.randn``)."""
    monkeypatch.setattr(tlm, "DRAW_CHUNK", 1000)
    scale = 0.25
    for shape in ((3, 40, 50), (2, 3, 20, 30), (5000, 8), (4, 300)):
        g = torch.Generator().manual_seed(1)
        x = tlm._normal(shape, scale, g, torch.bfloat16, "cpu")
        assert tuple(x.shape) == shape and x.dtype == torch.bfloat16
        xf = x.float()
        assert abs(float(xf.std()) - scale) < 0.02 * scale * 4
        assert abs(float(xf.mean())) < 0.02
        assert int((xf == 0).sum()) < xf.numel() // 100
    g = torch.Generator().manual_seed(2)
    whole = tlm._normal((3, 40, 50), scale, g, torch.float32, "cpu")
    g = torch.Generator().manual_seed(2)
    want = torch.randn((3, 40, 50), generator=g).mul_(scale)
    assert torch.equal(whole, want)
    # A bf16 model's parameters come out bf16 at rest, drawn in slices.
    cfg = dataclasses.replace(treg.get_tiny("phi35-moe-42b"),
                              param_dtype="bfloat16")
    p = tlm.init_params(cfg, 0, "cpu")
    w1 = p.tree()["layers"]["moe"]["w1"]
    assert w1.dtype == torch.bfloat16 and w1.numel() > 1000
    assert abs(float(w1.float().std()) * np.sqrt(cfg.d_model) - 1) < 0.05


@pytest.mark.parametrize("arch", ["phi35-moe-42b", "grok-1-314b"])
def test_train_refuses_mixture_of_experts(arch):
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        train.main(["--arch", arch, "--tiny", "--steps", "1"], device="cpu")


def test_chip_smoke_cut_configs_count_their_parameters():
    """``chip_smoke.py``'s ``CUT_MODELS``: each cut keeps every width and
    counts the parameters it states; the full depth is the registry's."""
    assert [a.replace("-", "_") for a in cs.CUT_MODELS] == \
        [a.replace("-", "_") for a in ARCHS]
    for arch, (cut, n_cut, depth, n_full) in cs.CUT_MODELS.items():
        full = treg.get(arch)[0]
        assert (full.n_layers, tlm.n_params(full)) == (depth, n_full)
        assert n_full == N_PARAMS[arch]
        assert tlm.n_params(dataclasses.replace(full, n_layers=cut)) == n_cut


def test_chip_smoke_records_counts_and_forces_expert_choices():
    """The harness of ``chip_smoke.py``'s mixture-of-experts phases on the
    CPU: each routing call's expert ids are recorded; a path whose
    attention output is perturbed routes some tokens apart, which
    ``routing_flips`` counts and places; run with the first path's
    choices, the unperturbed path gives its logits bit for bit and the
    perturbed one comes closer to them."""
    arch = "phi35-moe-42b"
    _, _, ct, pt = models(arch)
    batch = {"tokens": torch.from_numpy(
        _tokens(ct.vocab, (4, 32), seed=40)).long()}

    def noisy(q, k, v, **kw):
        out = tfa.flash_attention_ref(q, k, v, **kw)
        g = torch.Generator().manual_seed(41)
        return out + 0.05 * torch.randn(out.shape, generator=g)

    runs, logits = {}, {}
    for name, kw in (("clean", {}), ("noisy", {"flash_attention": noisy})):
        with cs.expert_choices(tmoe, record=runs.setdefault(name, [])):
            logits[name] = tlm.forward(pt, ct, batch, **kw)
    assert tmoe._top_k.__qualname__ == "_top_k"         # restored
    la, lb = logits["clean"], logits["noisy"]
    assert len(runs["clean"]) == len(runs["noisy"]) == ct.n_layers
    flips, first = cs.routing_flips(runs["clean"], runs["noisy"],
                                    ct.n_layers)
    assert flips["decode"] == (0, 0)
    d, t = flips["prefill"]
    assert t == 4 * 32 * ct.top_k * ct.n_layers and 0 < d < t
    call, rows, margin, median = first
    assert all(torch.equal(runs["clean"][i][0], runs["noisy"][i][0])
               for i in range(call))
    assert rows == int((runs["clean"][call][0] != runs["noisy"][call][0])
                       .any(-1).sum())
    assert 0 <= margin and 0 < median
    forced = {}
    for name, kw in (("clean", {}), ("noisy", {"flash_attention": noisy})):
        it = iter(runs["clean"])
        with cs.expert_choices(tmoe, force=it):
            forced[name] = tlm.forward(pt, ct, batch, **kw)
        assert next(it, None) is None
    assert torch.equal(forced["clean"], la)
    assert float((forced["noisy"] - la).abs().max()) < \
        float((lb - la).abs().max())
