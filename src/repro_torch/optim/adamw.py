"""AdamW with a configurable moment dtype, global-norm clipping and the
cosine schedule: the JAX package's ``repro/optim/adamw.py`` on PyTorch
trees (nested dicts of tensors, or a :class:`~repro_torch.models.lm.Model`).

The arithmetic is the reference's *as XLA compiles it*, in its order: the
moments ``b1 m + (1 - b1) g`` and ``b2 v + ((1 - b2) g) g`` with the
Python constants rounded to f32, the bias corrections ``1 - b ** count``
in f32 (``torch.pow`` on the host, which equals XLA's ``power`` here),
true divisions by device tensors (PyTorch's CUDA division by a Python
scalar would multiply by the reciprocal), and ``lr * weight_decay``
folded to one f32 before it scales the parameter.  The schedule folds
its divisions by constants into multiplies by their f32 reciprocals, as
XLA does; its ``cos`` is libm's, which differs from XLA's by an ulp at
some steps.

Unlike the reference, :meth:`AdamW.update` and :func:`clip_by_global_norm`
work in place: the parameters, moments and gradients are updated where
they lie, which keeps the training state at 16 bytes a parameter.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models.config import DTYPES
from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor          # int32, 0-dim, on the host


def _tree(params):
    return params.tree() if hasattr(params, "tree") else params


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"

    def init(self, params) -> AdamWState:
        dt = DTYPES[self.state_dtype]

        def z(p):
            return torch.zeros(p.shape, dtype=dt, device=p.device)
        tree = _tree(params)
        return AdamWState(m=tree_map(z, tree), v=tree_map(z, tree),
                          count=torch.zeros((), dtype=torch.int32))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr):
        """One step in place; -> (params, the state with the new count).
        ``lr`` is a float (taken as f32)."""
        c = state.count + 1
        cf = c.to(torch.float32)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        bc1 = 1.0 - torch.pow(f32(self.b1), cf)
        bc2 = 1.0 - torch.pow(f32(self.b2), cf)
        lr = float(np.float32(lr))
        lr_wd = float(np.float32(lr) * np.float32(self.weight_decay))
        plist = leaves(_tree(params))
        b1t, b2t = bc1.to(plist[0].device), bc2.to(plist[0].device)
        for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v),
                              plist):
            gf = g.float()
            mf = m.float()               # m itself when the moments are f32
            mf.mul_(self.b1).add_(gf * (1 - self.b1))
            vf = v.float()
            vf.mul_(self.b2).add_(gf * (1 - self.b2) * gf)
            den = torch.sqrt(vf / b2t).add_(self.eps)
            step = (mf / b1t).mul_(lr).div_(den)
            del den
            if self.weight_decay and p.ndim >= 2:   # no decay on norms/biases
                step.add_(p.float() * lr_wd)
            pf = p.float()
            pf.sub_(step)
            for dst, src in ((p, pf), (m, mf), (v, vf)):
                if src is not dst:
                    dst.copy_(src)
        state.count.copy_(c)
        return params, state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (f32), the per-leaf
    sums taken in the reference's leaf order."""
    sums = [torch.sum(x.float() ** 2) for x in leaves(tree)]
    dev = sums[0].device
    return torch.sqrt(torch.sum(torch.stack([s.to(dev) for s in sums])))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf in place by ``min(1, max_norm / max(norm, 1e-9))``;
    -> (tree, norm)."""
    n = global_norm(tree)
    scale = torch.clamp(
        torch.full_like(n, max_norm) / torch.clamp_min(n, 1e-9), max=1.0)
    for x in leaves(tree):
        x.mul_(scale.to(x.device))       # in f32, rounded to x's dtype
    return tree, n


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """-> ``lr(step)``: linear warmup to ``base_lr`` over ``warmup`` steps,
    then a cosine decay to 0 at ``total``; an f32 value (np.float32)."""
    inv_warm = np.float32(np.float32(base_lr) * np.float32(1.0 / max(warmup,
                                                                     1)))
    inv_span = np.float32(1.0 / max(total - warmup, 1))
    half = np.float32(0.5 * base_lr)

    def lr(step) -> np.float32:
        s = np.float32(int(step))
        if s < warmup:
            return np.float32((s + np.float32(1.0)) * inv_warm)
        prog = np.float32(min(max(np.float32(
            (s - np.float32(warmup)) * inv_span), 0.0), 1.0))
        cos = np.float32(torch.cos(torch.tensor(
            prog * np.float32(np.pi), dtype=torch.float32)))
        return np.float32((cos + np.float32(1.0)) * half)
    return lr
