"""The LM of the port: schema-driven parameters, forward / prefill / decode.

A :class:`~repro_torch.models.config.ModelConfig` picks a mixer per layer
from its block pattern: full or local attention (``attn`` /
``local_attn``), the RG-LRU recurrence (``rglru``) or the xLSTM family
(``mlstm`` / ``slstm``); an attention block's FFN is a mixture of experts
when the config has ``n_experts``.  The layer-0 input follows the config's
modality frontend, as the reference's stubs take it (:func:`_inputs_to_x`):
token embeddings (``none``), precomputed frame embeddings ``frames``
[B, S, d_model] (``audio_stub``: an encoder with no ``embed`` leaf), or
precomputed ``patch_embeds`` [B, P, d_model] put before the token
embeddings (``vision_stub``).

Parameters live in :class:`Model`, an ``nn.Module`` whose parameter names
mirror the JAX package's tree (``embed`` but for ``audio_stub``,
``final_ln``, ``unembed``, and ``blocks.<i>.<leaf>`` for a mixed stack).
A uniform stack with ``scan_layers`` keeps the reference's scanned
layout: each leaf under ``layers.<leaf>`` (``layers.mlp.<leaf>``)
stacked with a leading ``n_layers`` axis, and its cache one dict of
stacked leaves.  The step
functions loop over the layers, taking each layer's parameters as views
of the stacked leaves.  They take the module (or the nested dict
:meth:`ParamTree.tree` returns) and work on plain tensors, as the
reference's functions work on pytrees.  :func:`params_from_reference`
and :func:`cache_from_reference` / :func:`cache_to_reference` carry the
JAX package's parameters and caches across as numpy trees.

Training: :func:`loss_fn` runs :func:`forward_train`, the differentiable
forward (each block under ``torch.utils.checkpoint`` when ``cfg.remat`` is
set, the reference's ``jax.checkpoint``), and :func:`cross_entropy`.
Parameters take gradients when built with ``requires_grad=True``; serving
builds them without, and its entry points (:func:`forward`,
:func:`prefill`, :func:`decode_step`) run under ``torch.no_grad()``.

The step functions take keyword arguments naming another implementation
of a kernel's function (``mlstm_scan``, ``rglru_scan``,
``flash_attention``, ``decode_attention``); by default each block calls
the kernel's dispatch in :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.models import layers, rglru, xlstm
from repro_torch.models.config import DTYPES, ModelConfig
from repro_torch.models.layers import PSpec, ein, rms_norm
from repro_torch.tree import from_numpy, to_numpy

BLOCK_SCHEMAS = {
    "attn": partial(layers.attn_schema, local=False),
    "local_attn": partial(layers.attn_schema, local=True),
    "rglru": rglru.rglru_schema,
    "mlstm": xlstm.mlstm_schema,
    "slstm": xlstm.slstm_schema,
}

BLOCK_APPLY = {
    "attn": partial(layers.attn_block_apply, local=False),
    "local_attn": partial(layers.attn_block_apply, local=True),
    "rglru": rglru.rglru_block_apply,
    "mlstm": xlstm.mlstm_block_apply,
    "slstm": xlstm.slstm_block_apply,
}

BLOCK_PREFILL = {
    "attn": partial(layers.attn_block_prefill, local=False),
    "local_attn": partial(layers.attn_block_prefill, local=True),
    "rglru": rglru.rglru_block_prefill,
    "mlstm": xlstm.mlstm_block_prefill,
    "slstm": xlstm.slstm_block_prefill,
}

BLOCK_DECODE = {
    "attn": partial(layers.attn_block_decode, local=False),
    "local_attn": partial(layers.attn_block_decode, local=True),
    "rglru": rglru.rglru_block_decode,
    "mlstm": xlstm.mlstm_block_decode,
    "slstm": xlstm.slstm_block_decode,
}

# kind -> (cfg, batch, t_cache) -> the layer's cache schema.
CACHE_SCHEMAS = {
    "attn": lambda cfg, b, t: layers.attn_cache_schema(cfg, b, t, False),
    "local_attn": lambda cfg, b, t: layers.attn_cache_schema(cfg, b, t,
                                                             True),
    "rglru": lambda cfg, b, t: rglru.rglru_cache_schema(cfg, b),
    "mlstm": lambda cfg, b, t: xlstm.mlstm_cache_schema(cfg, b),
    "slstm": lambda cfg, b, t: xlstm.slstm_cache_schema(cfg, b),
}

# The kernels a caller may replace by name (see the module docstring).
KERNELS = ("mlstm_scan", "rglru_scan", "flash_attention", "decode_attention")


FRONTENDS = ("none", "audio_stub", "vision_stub")


def _check_config(cfg: ModelConfig) -> None:
    for kind in cfg.blocks():
        if kind not in BLOCK_SCHEMAS:
            raise KeyError(kind)
    if cfg.frontend not in FRONTENDS:
        raise KeyError(f"unknown frontend {cfg.frontend!r} ({cfg.name}); "
                       f"known: {list(FRONTENDS)}")


def _check_kernels(kernels: dict) -> None:
    bad = sorted(set(kernels) - set(KERNELS))
    if bad:
        raise TypeError(f"unknown kernel argument(s) {bad}; known: "
                        f"{list(KERNELS)}")


# ---------------------------------------------------------------------------
# Schema / parameters
# ---------------------------------------------------------------------------

def _scanned(cfg: ModelConfig) -> bool:
    """A uniform stack kept as stacked leaves (the reference's scan)."""
    return cfg.scan_layers and cfg.uniform_stack and cfg.n_layers > 1


def _stack(schema, n: int):
    if isinstance(schema, PSpec):
        return PSpec((n,) + tuple(schema.shape),
                     ("layers",) + tuple(schema.axes), schema.init)
    return {k: _stack(v, n) for k, v in schema.items()}


def build_schema(cfg: ModelConfig) -> dict:
    _check_config(cfg)
    d, v = cfg.d_model, cfg.vocab
    audio = cfg.frontend == "audio_stub"
    sch = {} if audio else {
        "embed": PSpec((v, d), ("vocab", "embed"), ("normal", 1.0))}
    sch["final_ln"] = PSpec((d,), ("norm",), ("zeros",))
    if not cfg.tie_embeddings or audio:
        sch["unembed"] = PSpec((d, v), ("embed", "vocab"),
                               ("normal", 1.0 / np.sqrt(d)))
    blocks = cfg.blocks()
    if _scanned(cfg):
        sch["layers"] = _stack(BLOCK_SCHEMAS[blocks[0]](cfg), cfg.n_layers)
    else:
        sch["blocks"] = [BLOCK_SCHEMAS[k](cfg) for k in blocks]
    return sch


def n_params(cfg: ModelConfig) -> int:
    """The number of parameters the schema holds."""
    def count(node):
        if isinstance(node, PSpec):
            return int(np.prod(node.shape))
        items = node.values() if isinstance(node, dict) else node
        return sum(count(x) for x in items)
    return count(build_schema(cfg))


# Elements of one f32 draw of a leaf that is not f32 at rest (1 GiB).
DRAW_CHUNK = 1 << 28


def _normal(shape: tuple, scale: float, gen: torch.Generator, dtype,
            device) -> torch.Tensor:
    """Normal(0, scale) values drawn in f32 and cast to ``dtype``.  A leaf
    that is not f32 and holds more than ``DRAW_CHUNK`` elements is drawn
    in slices of its leading axis (each slice split again the same way),
    so the f32 draw never holds more than a slice beside the weights: a
    bf16 expert leaf at a full width holds billions of elements.  An f32
    leaf is drawn whole: the models f32 at rest (xlstm-125m, yi-6b,
    recurrentgemma-2b, gemma-7b) draw the values one ``torch.randn`` of
    the leaf gives."""
    n = int(np.prod(shape))
    if dtype == torch.float32 or n <= DRAW_CHUNK or len(shape) < 2:
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    step = DRAW_CHUNK // (n // shape[0])
    if step == 0:                       # a slice is over the chunk: split it
        for i in range(shape[0]):
            out[i] = _normal(shape[1:], scale, gen, dtype, device)
        return out
    for i in range(0, shape[0], step):
        out[i:i + step] = _normal((min(step, shape[0] - i),) + shape[1:],
                                  scale, gen, dtype, device)
    return out


def _init_leaf(ps: PSpec, gen: torch.Generator, dtype, device):
    kind = ps.init[0]
    if kind == "normal":
        return _normal(tuple(ps.shape), ps.init[1], gen, dtype, device)
    if kind == "zeros":
        return torch.zeros(ps.shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(ps.shape, dtype=dtype, device=device)
    if kind == "const":
        return torch.full(ps.shape, ps.init[1], dtype=dtype, device=device)
    raise ValueError(kind)


class ParamTree(nn.Module):
    """A nested schema as modules: a :class:`PSpec` leaf is a parameter, a
    dict a submodule, a list an ``nn.ModuleList``.  ``leaf(spec, path)``
    gives each leaf's tensor, visited in sorted-key order (the order the
    reference's tree flattens in); the parameters take gradients when
    ``requires_grad`` is set."""

    def __init__(self, schema: dict, leaf, path: tuple = (),
                 requires_grad: bool = False):
        super().__init__()
        for name in sorted(schema):
            node = schema[name]
            if isinstance(node, PSpec):
                self.register_parameter(name, nn.Parameter(
                    leaf(node, path + (name,)), requires_grad=requires_grad))
            elif isinstance(node, list):
                self.add_module(name, nn.ModuleList(
                    ParamTree(s, leaf, path + (name, i), requires_grad)
                    for i, s in enumerate(node)))
            else:
                self.add_module(name, ParamTree(node, leaf, path + (name,),
                                                requires_grad))

    def tree(self) -> dict:
        """The parameters as the nested dict / list tree of the schema."""
        out = dict(self.named_parameters(recurse=False))
        for name, mod in self.named_children():
            out[name] = [m.tree() for m in mod] \
                if isinstance(mod, nn.ModuleList) else mod.tree()
        return out


class Model(ParamTree):
    """The LM's parameters for one config (its schema's leaves)."""

    def __init__(self, cfg: ModelConfig, leaf, requires_grad: bool = False):
        super().__init__(build_schema(cfg), leaf, requires_grad=requires_grad)


def init_params(cfg: ModelConfig, seed: int = 0, device=None, *,
                requires_grad: bool = False) -> Model:
    """Random parameters from the schema's init recipes, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device (not
    bit-equal to the reference's ``jax.random`` init).  Training asks for
    ``requires_grad``; serving does not."""
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = DTYPES[cfg.param_dtype]
    return Model(cfg, lambda ps, _path: _init_leaf(ps, gen, dtype, dev),
                 requires_grad)


def _lookup(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def params_from_reference(cfg: ModelConfig, np_tree, device=None, *,
                          requires_grad: bool = False) -> Model:
    """A :class:`Model` holding the JAX package's parameter tree (its
    leaves as numpy arrays or anything ``np.asarray`` takes)."""
    dev = resolve(device)
    dtype = DTYPES[cfg.param_dtype]

    def leaf(ps: PSpec, path):
        x = np.asarray(_lookup(np_tree, path), np.float32)
        if x.shape != tuple(ps.shape):
            raise ValueError(f"reference leaf {'/'.join(map(str, path))} "
                             f"has shape {x.shape}, schema {ps.shape}")
        return torch.from_numpy(x.copy()).to(dtype=dtype, device=dev)

    return Model(cfg, leaf, requires_grad)


def _tree(params) -> dict:
    return params.tree() if isinstance(params, ParamTree) else params


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def cache_schema(cfg: ModelConfig, batch: int, t_cache: int):
    """One dict of :class:`PSpec` per layer, or for a scanned stack one
    dict of stacked leaves (the recurrent blocks' states do not grow with
    ``t_cache``)."""
    _check_config(cfg)
    blocks = cfg.blocks()
    if _scanned(cfg):
        return _stack(CACHE_SCHEMAS[blocks[0]](cfg, batch, t_cache),
                      cfg.n_layers)
    return [CACHE_SCHEMAS[k](cfg, batch, t_cache) for k in blocks]


def _cache_leaf_dtype(cfg: ModelConfig, ps: PSpec) -> torch.dtype:
    """KV entries in the compute dtype, recurrent states in f32."""
    if ps.init[0] == "zeros" and len(ps.shape) >= 4 and \
            ps.axes[-1] == "head_dim":
        return cfg.compute_dtype()
    return torch.float32


def _map_cache(fn, cache):
    if isinstance(cache, list):
        return [{k: fn(v) for k, v in layer.items()} for layer in cache]
    return {k: fn(v) for k, v in cache.items()}


def init_cache(cfg: ModelConfig, batch: int, t_cache: int, device=None):
    """KV entries zeros in the compute dtype; recurrent states in f32:
    zeros, and ``-1e30`` for the running max."""
    dev = resolve(device)

    def leaf(ps: PSpec):
        if ps.init[0] == "const":
            return torch.full(ps.shape, ps.init[1], dtype=torch.float32,
                              device=dev)
        return torch.zeros(ps.shape, dtype=_cache_leaf_dtype(cfg, ps),
                           device=dev)

    return _map_cache(leaf, cache_schema(cfg, batch, t_cache))


def cache_from_reference(np_cache, device=None):
    """The JAX package's cache (a list of per-layer dicts, or one dict of
    stacked leaves for a scanned stack) as tensors of the same dtypes."""
    dev = resolve(device)
    return _map_cache(lambda v: from_numpy(np.array(v, copy=True)).to(dev),
                      np_cache)


def cache_to_reference(cache):
    """The port's cache as the JAX package's tree of numpy arrays."""
    return _map_cache(to_numpy, cache)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def _embed_tokens(p: dict, cfg: ModelConfig, tokens):
    """The token embeddings in the compute dtype; with ``emb_scale``,
    widened to f32 and times sqrt(d_model) in f32.  The reference
    multiplies by ``np.sqrt``'s f64 scalar, which JAX takes as a strongly
    typed f32, so an embedding-scaled model's residual stream is f32 from
    here on (its norms return f32, its projections round their input to
    the compute dtype)."""
    x = p["embed"][tokens].to(cfg.compute_dtype())
    if cfg.emb_scale:
        x = x.float() * np.float32(np.sqrt(cfg.d_model))
    return x


def _inputs_to_x(p: dict, cfg: ModelConfig, batch):
    """The layer-0 input of a batch (the reference's ``_inputs_to_x``):
    ``frames`` in the compute dtype for ``audio_stub``; for
    ``vision_stub`` the ``patch_embeds`` in the compute dtype put before
    the token embeddings (an embedding-scaled model's f32 ones widen the
    patches to f32, as JAX's concatenate promotes); else the token
    embeddings."""
    dtype = cfg.compute_dtype()
    if cfg.frontend == "audio_stub":
        return batch["frames"].to(dtype)
    x = _embed_tokens(p, cfg, batch["tokens"])
    if cfg.frontend == "vision_stub":
        patches = batch["patch_embeds"].to(dtype)
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    return x


def _unembed(p: dict, cfg: ModelConfig, x):
    dtype = cfg.compute_dtype()
    x = rms_norm(x, p["final_ln"], cfg.norm_eps)
    if "unembed" in p:
        logits = ein("bsd,dv->bsv", x, p["unembed"].to(dtype),
                     dtype=torch.float32)
    else:
        logits = ein("bsd,vd->bsv", x, p["embed"].to(dtype),
                     dtype=torch.float32)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None] \
        .expand(b, s)


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------

def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree, as views."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layers(p: dict, cfg: ModelConfig):
    """(kind, parameters) of each layer in order."""
    if _scanned(cfg):
        kind = cfg.blocks()[0]
        return [(kind, _layer(p["layers"], i)) for i in range(cfg.n_layers)]
    return list(zip(cfg.blocks(), p["blocks"]))


def _layer_caches(cache, cfg: ModelConfig) -> list:
    if _scanned(cfg):
        return [_layer(cache, i) for i in range(cfg.n_layers)]
    return cache


def _join_caches(caches: list, cfg: ModelConfig):
    """Per-layer caches back into the config's cache tree."""
    if _scanned(cfg):
        return {k: torch.stack([c[k] for c in caches])
                for k in caches[0]}
    return caches


def forward_train(params, cfg: ModelConfig, batch, **kernels):
    """-> f32 logits [B, S, V], differentiable.  With ``cfg.remat`` and
    grad mode on, each block runs under ``torch.utils.checkpoint``: only
    its input is saved, and the backward runs it again (the reference's
    ``jax.checkpoint`` per block, ``repro/models/lm.py:250-265``)."""
    _check_kernels(kernels)
    p = _tree(params)
    x = _inputs_to_x(p, cfg, batch)
    positions = _positions(*x.shape[:2], x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for kind, lp in _layers(p, cfg):
        fn = partial(_block_in_range, BLOCK_APPLY[kind], cfg=cfg,
                     positions=positions, **kernels)
        if remat:
            # The blocks draw no random numbers: no RNG state to keep.
            x = checkpoint(fn, lp, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = fn(lp, x)
    return _unembed(p, cfg, x)


def _block_in_range(apply, lp, x, **kw):
    """``apply(lp, x)`` inside the profiler range ``repro_torch.block``,
    which remat enters again when the backward recomputes the block."""
    with record_function("repro_torch.block"):
        return apply(lp, x, **kw)


@torch.no_grad()
def forward(params, cfg: ModelConfig, batch, **kernels):
    """-> f32 logits [B, S, V] (no gradients)."""
    return forward_train(params, cfg, batch, **kernels)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch, cache, **kernels):
    """Fill the cache from a prompt; -> (last-token logits [B,1,V], cache).
    The input cache is not modified."""
    _check_kernels(kernels)
    p = _tree(params)
    x = _inputs_to_x(p, cfg, batch)
    positions = _positions(*x.shape[:2], x.device)
    new_cache = []
    for (kind, lp), lc in zip(_layers(p, cfg), _layer_caches(cache, cfg)):
        x, nc = BLOCK_PREFILL[kind](lp, x, cfg, positions=positions,
                                    cache=lc, **kernels)
        new_cache.append(nc)
    return _unembed(p, cfg, x[:, -1:]), _join_caches(new_cache, cfg)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens, lengths, cache,
                **kernels):
    """One token for every sequence. tokens [B,1]; lengths [B] (positions).
    -> (logits [B,1,V], cache, lengths + 1).  The input cache is not
    modified.  An ``audio_stub`` model has no embedding: ``tokens`` pass
    through as the layer-0 input, as in the reference (encoder-only
    configs are never decoded)."""
    _check_kernels(kernels)
    p = _tree(params)
    x = tokens if cfg.frontend == "audio_stub" else \
        _embed_tokens(p, cfg, tokens)
    positions = lengths[:, None].to(torch.int32)
    new_cache = []
    for (kind, lp), lc in zip(_layers(p, cfg), _layer_caches(cache, cfg)):
        x, nc = BLOCK_DECODE[kind](lp, x, cfg, positions=positions,
                                   cache=lc, lengths=lengths, **kernels)
        new_cache.append(nc)
    return _unembed(p, cfg, x), _join_caches(new_cache, cfg), lengths + 1


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels):
    """Mean next-token NLL. logits f32 [B,S,V]; labels [B,S] (-1 = pad).

    The reference's formula (``repro/models/lm.py:331-342``) with the
    label's logit gathered instead of summed against a [B,S,V] one-hot:
    that sum adds only exact zeros to the one term, so the value is the
    same, and the one-hot would cost as much memory as the logits."""
    m = torch.amax(logits.detach(), dim=-1, keepdim=True)
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0]
    idx = torch.clamp_min(labels, 0).long()[..., None]
    correct = torch.gather(shifted, -1, idx)[..., 0] + m[..., 0]
    w = (labels >= 0).to(torch.float32)
    nll = (lse - correct) * w
    return torch.sum(nll) / torch.clamp_min(torch.sum(w), 1.0)


def loss_fn(params, cfg: ModelConfig, batch, **kernels):
    """-> (loss, {"loss": loss}) of :func:`forward_train` on
    ``batch["tokens"]`` against ``batch["labels"]``."""
    logits = forward_train(params, cfg, batch, **kernels)
    loss = cross_entropy(logits, batch["labels"])
    return loss, {"loss": loss}
