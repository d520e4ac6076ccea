"""The LM of the port: schema-driven parameters, forward / prefill / decode.

A :class:`~repro_torch.models.config.ModelConfig` picks a mixer per layer
from its block pattern.  The port runs the xLSTM family so far
(``mlstm`` / ``slstm`` blocks, unscanned mixed stacks, token inputs); any
other block kind, a scanned uniform stack or a modality frontend raises
``NotImplementedError`` naming it.

Parameters live in :class:`Model`, an ``nn.Module`` whose parameter names
mirror the JAX package's tree (``embed``, ``final_ln``, ``unembed``,
``blocks.<i>.<leaf>``, ``blocks.<i>.mlp.<leaf>``).  The step functions
take the module (or the nested dict :meth:`ParamTree.tree` returns) and
work on plain tensors, as the reference's functions work on pytrees.
:func:`params_from_reference` and :func:`cache_from_reference` /
:func:`cache_to_reference` carry the JAX package's parameters and caches
across as numpy trees.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve
from repro_torch.models import xlstm
from repro_torch.models.config import DTYPES, ModelConfig
from repro_torch.models.layers import PSpec, ein, rms_norm

BLOCK_SCHEMAS = {
    "mlstm": xlstm.mlstm_schema,
    "slstm": xlstm.slstm_schema,
}

BLOCK_APPLY = {
    "mlstm": xlstm.mlstm_block_apply,
    "slstm": xlstm.slstm_block_apply,
}

BLOCK_PREFILL = {
    "mlstm": xlstm.mlstm_block_prefill,
    "slstm": xlstm.slstm_block_prefill,
}

BLOCK_DECODE = {
    "mlstm": xlstm.mlstm_block_decode,
    "slstm": xlstm.slstm_block_decode,
}

CACHE_SCHEMAS = {
    "mlstm": xlstm.mlstm_cache_schema,
    "slstm": xlstm.slstm_cache_schema,
}

# Block kinds of the JAX package that the port does not run yet.
_LATER_BLOCKS = ("attn", "local_attn", "rglru")


def _check_config(cfg: ModelConfig) -> None:
    for kind in cfg.blocks():
        if kind in _LATER_BLOCKS:
            raise NotImplementedError(
                f"block kind {kind!r} ({cfg.name}) is not ported to "
                f"repro_torch yet (ported: {sorted(BLOCK_SCHEMAS)})")
        if kind not in BLOCK_SCHEMAS:
            raise KeyError(kind)
    if cfg.scan_layers and cfg.uniform_stack and cfg.n_layers > 1:
        raise NotImplementedError(
            f"scanned uniform stacks ({cfg.name}) are not ported to "
            f"repro_torch yet")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"frontend {cfg.frontend!r} ({cfg.name}) is not ported to "
            f"repro_torch yet")


# ---------------------------------------------------------------------------
# Schema / parameters
# ---------------------------------------------------------------------------

def build_schema(cfg: ModelConfig) -> dict:
    _check_config(cfg)
    d, v = cfg.d_model, cfg.vocab
    sch = {"embed": PSpec((v, d), ("vocab", "embed"), ("normal", 1.0)),
           "final_ln": PSpec((d,), ("norm",), ("zeros",))}
    if not cfg.tie_embeddings:
        sch["unembed"] = PSpec((d, v), ("embed", "vocab"),
                               ("normal", 1.0 / np.sqrt(d)))
    sch["blocks"] = [BLOCK_SCHEMAS[k](cfg) for k in cfg.blocks()]
    return sch


def _init_leaf(ps: PSpec, gen: torch.Generator, dtype, device):
    kind = ps.init[0]
    if kind == "normal":
        x = torch.randn(ps.shape, generator=gen, dtype=torch.float32,
                        device=device) * ps.init[1]
        return x.to(dtype)
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
    reference's tree flattens in)."""

    def __init__(self, schema: dict, leaf, path: tuple = ()):
        super().__init__()
        for name in sorted(schema):
            node = schema[name]
            if isinstance(node, PSpec):
                self.register_parameter(name, nn.Parameter(
                    leaf(node, path + (name,)), requires_grad=False))
            elif isinstance(node, list):
                self.add_module(name, nn.ModuleList(
                    ParamTree(s, leaf, path + (name, i))
                    for i, s in enumerate(node)))
            else:
                self.add_module(name, ParamTree(node, leaf, path + (name,)))

    def tree(self) -> dict:
        """The parameters as the nested dict / list tree of the schema."""
        out = dict(self.named_parameters(recurse=False))
        for name, mod in self.named_children():
            out[name] = [m.tree() for m in mod] \
                if isinstance(mod, nn.ModuleList) else mod.tree()
        return out


class Model(ParamTree):
    """The LM's parameters for one config (its schema's leaves)."""

    def __init__(self, cfg: ModelConfig, leaf):
        super().__init__(build_schema(cfg), leaf)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """Random parameters from the schema's init recipes, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device (not
    bit-equal to the reference's ``jax.random`` init)."""
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = DTYPES[cfg.param_dtype]
    return Model(cfg, lambda ps, _path: _init_leaf(ps, gen, dtype, dev))


def _lookup(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def params_from_reference(cfg: ModelConfig, np_tree, device=None) -> Model:
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

    return Model(cfg, leaf)


def _tree(params) -> dict:
    return params.tree() if isinstance(params, ParamTree) else params


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def cache_schema(cfg: ModelConfig, batch: int, t_cache: int) -> list:
    """One dict of :class:`PSpec` per layer (the recurrent blocks' states
    do not grow with ``t_cache``)."""
    _check_config(cfg)
    return [CACHE_SCHEMAS[k](cfg, batch) for k in cfg.blocks()]


def init_cache(cfg: ModelConfig, batch: int, t_cache: int,
               device=None) -> list:
    """Recurrent states in f32: zeros, and ``-1e30`` for the running max."""
    dev = resolve(device)

    def leaf(ps: PSpec):
        fill = ps.init[1] if ps.init[0] == "const" else 0.0
        return torch.full(ps.shape, fill, dtype=torch.float32, device=dev)

    return [{k: leaf(ps) for k, ps in layer.items()}
            for layer in cache_schema(cfg, batch, t_cache)]


def cache_from_reference(np_cache, device=None) -> list:
    """The JAX package's cache (a list of per-layer dicts) as tensors."""
    dev = resolve(device)
    return [{k: torch.from_numpy(np.array(v, copy=True)).to(dev)
             for k, v in layer.items()} for layer in np_cache]


def cache_to_reference(cache) -> list:
    """The port's cache as the JAX package's tree of numpy arrays."""
    return [{k: v.detach().cpu().numpy() for k, v in layer.items()}
            for layer in cache]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def _embed_tokens(p: dict, cfg: ModelConfig, tokens):
    x = p["embed"][tokens].to(cfg.compute_dtype())
    if cfg.emb_scale:
        x = x * np.sqrt(cfg.d_model)
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

@torch.no_grad()
def forward(params, cfg: ModelConfig, batch, *, mlstm_scan=None):
    """-> f32 logits [B, S, V].  ``mlstm_scan`` replaces the mLSTM
    blocks' scan (default: the kernel's dispatch)."""
    p = _tree(params)
    x = _embed_tokens(p, cfg, batch["tokens"])
    positions = _positions(*x.shape[:2], x.device)
    for lp, kind in zip(p["blocks"], cfg.blocks()):
        x = BLOCK_APPLY[kind](lp, x, cfg, positions=positions,
                              mlstm_scan=mlstm_scan)
    return _unembed(p, cfg, x)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch, cache, *, mlstm_scan=None):
    """Fill the cache from a prompt; -> (last-token logits [B,1,V], cache)."""
    p = _tree(params)
    x = _embed_tokens(p, cfg, batch["tokens"])
    positions = _positions(*x.shape[:2], x.device)
    new_cache = []
    for lp, lc, kind in zip(p["blocks"], cache, cfg.blocks()):
        x, nc = BLOCK_PREFILL[kind](lp, x, cfg, positions=positions,
                                    cache=lc, mlstm_scan=mlstm_scan)
        new_cache.append(nc)
    return _unembed(p, cfg, x[:, -1:]), new_cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens, lengths, cache, *,
                mlstm_scan=None):
    """One token for every sequence. tokens [B,1]; lengths [B] (positions).
    -> (logits [B,1,V], cache, lengths + 1)."""
    p = _tree(params)
    x = _embed_tokens(p, cfg, tokens)
    positions = lengths[:, None].to(torch.int32)
    new_cache = []
    for lp, lc, kind in zip(p["blocks"], cache, cfg.blocks()):
        x, nc = BLOCK_DECODE[kind](lp, x, cfg, positions=positions,
                                   cache=lc, lengths=lengths,
                                   mlstm_scan=mlstm_scan)
        new_cache.append(nc)
    return _unembed(p, cfg, x), new_cache, lengths + 1
