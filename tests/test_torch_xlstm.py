"""The port's xLSTM model (plain path, CPU) against the JAX package's,
compiled (``jax.jit``), with the JAX parameters carried across by
``params_from_reference``: the mLSTM and sLSTM blocks (from zeros and
from a carry), ``lm.prefill`` then four ``lm.decode_step``s, and
``lm.forward``.  Three configs: xlstm-tiny in f32, xlstm-tiny in bf16, and
xlstm-125m's full width (d_model 768, 4 heads of 192, bf16) cut to 2
layers and a vocab of 512, so the dh = 192 path is covered.

Inputs are made with numpy from a seed.  Tolerances, in the compute
dtype: f32 within 1e-4 (absolute and relative; the two sides' exp, tanh
and log1p differ in ulps); bf16 within 3% of the reference's largest
magnitude (max abs difference), since the two sides round different
elements of the same bf16 activations (XLA keeps some fused bf16
intermediates in f32) and a flipped bf16 ulp is 0.4% of its value."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.models import xlstm as jx
from repro_torch.configs import registry as treg
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models import xlstm as tx

CONFIGS = ["tiny-f32", "tiny-bf16", "wide-2l"]
DTYPES_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def configs(name):
    """(JAX config, port config) of one test config."""
    if name == "tiny-f32":
        return jreg.get_tiny("xlstm-125m"), treg.get_tiny("xlstm-125m")
    if name == "tiny-bf16":
        return tuple(dataclasses.replace(c, dtype="bfloat16") for c in
                     (jreg.get_tiny("xlstm-125m"),
                      treg.get_tiny("xlstm-125m")))
    kw = dict(n_layers=2, vocab=512)
    return (dataclasses.replace(jreg.get("xlstm-125m")[0], **kw),
            dataclasses.replace(treg.get("xlstm-125m")[0], **kw))


@functools.lru_cache(maxsize=None)
def models(name):
    """JAX config + params, port config + Model (same weights)."""
    cj, ct = configs(name)
    pj = jlm.init_params(cj, 0)
    pt = tlm.params_from_reference(ct, jax.tree.map(np.asarray, pj), "cpu")
    return cj, pj, ct, pt


def assert_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        err = float(np.abs(got - want).max())
        assert err <= 0.03 * float(np.abs(want).max()), err


def _x(cfg, b, s, seed):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(x).astype(DTYPES_JAX[cfg.dtype]),
            torch.from_numpy(x).to(getattr(torch, cfg.dtype)))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _carry(kind, cfg, b, seed):
    """A mid-sequence carry for one block kind, made with numpy."""
    rng = np.random.default_rng(seed)
    h, dh = cfg.n_heads, cfg.head_dim
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    if kind == "mlstm":
        return (np.abs(f(b, h, dh, dh)) * 0.1, np.abs(f(b, h, dh)) * 0.1,
                f(b, h))
    return (f(b, h, dh) * 0.5, f(b, h, dh) * 0.5,
            np.abs(f(b, h, dh)) + 1.0, f(b, h, dh))


BLOCKS = {"mlstm": (0, jx._mlstm_block, tx._mlstm_block),
          "slstm": (1, jx._slstm_block, tx._slstm_block)}


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("with_carry", [False, True])
def test_block_matches_jitted_reference(name, kind, with_carry):
    cj, pj, ct, pt = models(name)
    i, fj, ft = BLOCKS[kind]
    b, s = 2, (1 if with_carry else 12)
    xj, xt = _x(cj, b, s, seed=11)
    carry = _carry(kind, cj, b, seed=12) if with_carry else None
    cjx = None if carry is None else tuple(jnp.asarray(c) for c in carry)
    ctx = None if carry is None else tuple(_t(c) for c in carry)
    yj, cj_out = jax.jit(lambda p, x, c: fj(p, x, cj, c))(
        pj["blocks"][i], xj, cjx)
    yt, ct_out = ft(pt.tree()["blocks"][i], xt, ct, ctx)
    assert yt.dtype == ct.compute_dtype()
    assert_close(yt.float().numpy(), yj.astype(jnp.float32), cj.dtype)
    for a, w in zip(ct_out, cj_out):
        assert a.dtype == torch.float32
        assert_close(a.numpy(), w, cj.dtype)


@pytest.mark.parametrize("name", CONFIGS)
def test_init_cache_matches_reference(name):
    cj, _, ct, _ = models(name)
    want = jlm.init_cache(cj, 3, 16)
    got = tlm.cache_to_reference(tlm.init_cache(ct, 3, 16, "cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            a, b = g[k], np.asarray(w[k])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("name", CONFIGS + ["full"])
def test_schema_matches_reference(name):
    if name == "full":
        cj, ct = jreg.get("xlstm-125m")[0], treg.get("xlstm-125m")[0]
    else:
        cj, ct = configs(name)
    flat = lambda tree: {
        jax.tree_util.keystr(path): (tuple(ps.shape), tuple(ps.axes),
                                     tuple(ps.init))
        for path, ps in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    assert flat(tlm.build_schema(ct)) == flat(jlm.build_schema(cj))


def test_full_config_has_the_published_size():
    """xlstm-125m at full width: 130,425,648 parameters (the count of the
    JAX package's abstract params), counted from the schema."""
    cfg = treg.get("xlstm-125m")[0]
    leaves = jax.tree_util.tree_leaves(
        tlm.build_schema(cfg), is_leaf=lambda x: hasattr(x, "axes"))
    n = sum(int(np.prod(ps.shape)) for ps in leaves)
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        jlm.abstract_params(jreg.get("xlstm-125m")[0])))
    assert n == want == 130_425_648
    assert cfg.compute_dtype() == torch.bfloat16
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jreg.get("xlstm-125m")[0])


def test_parameter_names_mirror_the_reference_tree():
    _, pj, _, pt = models("tiny-f32")
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(pj)[0]}
    assert set(dict(pt.named_parameters())) == want
    assert {"embed", "final_ln", "unembed", "blocks.0.wq",
            "blocks.1.mlp.wi"} <= want


def test_init_params_is_seeded():
    cfg = treg.get_tiny("xlstm-125m")
    a = tlm.init_params(cfg, 0, "cpu")
    b = tlm.init_params(cfg, 0, "cpu")
    c = tlm.init_params(cfg, 1, "cpu")
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["embed"], pc["embed"])
    assert all(p.dtype == torch.float32 for p in pa.values())
    assert torch.all(pa["blocks.0.b_f"] == 3.0)


def test_entry_points_need_a_card_unless_told_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = treg.get_tiny("xlstm-125m")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_cache(cfg, 1, 8)


def test_registry_raises_for_what_is_not_ported():
    """Every architecture of the reference is ported; an unknown name, an
    unknown frontend and training a frontend config are still refused."""
    assert sorted(treg.PORTED) == sorted(jreg.ARCHS)
    for arch in treg.ALIASES:
        assert dataclasses.asdict(treg.get(arch)[0]) == \
            dataclasses.asdict(jreg.get(arch)[0])
    with pytest.raises(KeyError):
        treg.get("no-such-arch")
    assert treg.ALIASES == jreg.ALIASES
    cfg = treg.get_tiny("xlstm-125m")
    with pytest.raises(KeyError, match="no_such_frontend"):
        tlm.build_schema(dataclasses.replace(cfg,
                                             frontend="no_such_frontend"))
    vision = dataclasses.replace(cfg, frontend="vision_stub")
    assert "embed" in tlm.build_schema(vision)
    with pytest.raises(NotImplementedError, match="vision_stub"):
        ttrain.main(["--arch", "llava-next-mistral-7b", "--tiny"],
                    device="cpu")
