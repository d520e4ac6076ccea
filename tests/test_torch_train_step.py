"""One training step of the port (``repro_torch.train.step.
make_train_step``, plain path on the CPU) against the JAX package's
``make_train_step``, compiled (``jax.jit``), from the same parameters
(``params_from_reference``) and the same batch (the data pipeline's),
on recurrentgemma-tiny in f32 with 1 and 2 microbatches (yi-tiny in
``tests/test_torch_train_step_yi.py``).  Compared: the loss, the grad
norm and the learning rate the step reports; the clipped gradients the
optimizer receives (captured from the port's ``AdamW.update``, held
against ``jax.grad`` of the reference's ``loss_fn`` summed over the
microbatches, divided and clipped as its step does); and the updated
parameters where the gradient is not near zero.

Tolerances, f32: the loss and the grad norm within 1e-5 relative; each
gradient leaf within 1e-5 of its largest magnitude (the port's attention
and scan kernels sum in other orders than the reference's jnp attention
and associative scan: ~1e-6 seen); the updated parameters within 2e-6
where ``|g| >= 1e-3`` of the leaf's largest, since Adam's first step
moves a parameter by about ``lr * g / (|g| + eps)``, so a gradient near 0
of another rounding (or sign) moves it by a different amount and is no
fault."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.optim import adamw as jad
from repro.train.step import make_train_step as jmake
from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import DataConfig, TokenDataset
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tad
from repro_torch.train.step import make_train_step as tmake
from repro_torch.tree import leaves

STEP = 3                       # inside the warmup-to-cosine schedule below


@functools.lru_cache(maxsize=None)
def _reference(arch):
    cj = jreg.get_tiny(arch)
    pj = jlm.init_params(cj, 0)
    batch = TokenDataset(DataConfig(vocab=cj.vocab, seq_len=24,
                                    global_batch=4, seed=1)).batch(0)
    grad = jax.jit(jax.grad(lambda p, b: jlm.loss_fn(p, cj, b)[0]))
    return cj, pj, batch, grad


def check_one_step(arch, microbatches):
    cj, pj, batch, grad = _reference(arch)
    ct = treg.get_tiny(arch)
    jopt = jad.AdamW()
    jstep = jax.jit(jmake(cj, jopt, jad.cosine_schedule(1e-3, 2, 10),
                          microbatches=microbatches))
    jp, _, jnext, jm = jstep(pj, jopt.init(pj), jnp.int32(STEP),
                             {k: jnp.asarray(v) for k, v in batch.items()})

    seen = {}

    class Capture(tad.AdamW):
        def update(self, grads, state, params, lr):
            seen["grads"] = [g.clone() for g in leaves(grads)]
            return super().update(grads, state, params, lr)

    pt = tlm.params_from_reference(ct, jax.tree.map(np.asarray, pj), "cpu",
                                   requires_grad=True)
    opt = Capture()
    tstep = tmake(ct, opt, tad.cosine_schedule(1e-3, 2, 10),
                  microbatches=microbatches)
    tp, ts, tnext, tm = tstep(pt, opt.init(pt), STEP,
                              {k: torch.from_numpy(v).long()
                               for k, v in batch.items()})
    assert tnext == int(jnext) == STEP + 1 and int(ts.count) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert tm["lr"] == np.float32(jm["lr"])
    assert all(p.grad is None for p in tp.parameters())

    # The reference's gradient as its step forms it.
    n = batch["tokens"].shape[0] // microbatches
    g = None
    for i in range(microbatches):
        gi = grad(pj, {k: jnp.asarray(v[i * n:(i + 1) * n])
                       for k, v in batch.items()})
        g = gi if g is None else jax.tree.map(jnp.add, g, gi)
    g, _ = jad.clip_by_global_norm(jax.tree.map(lambda x: x / microbatches,
                                                g), 1.0)
    want_g = [np.asarray(x) for x in jax.tree.leaves(g)]
    assert len(want_g) == len(seen["grads"])
    for w, t in zip(want_g, seen["grads"]):
        big = float(np.abs(w).max())
        assert float(np.abs(t.numpy() - w).max()) <= 1e-5 * big + 1e-30
    for w, t, gw in zip(jax.tree.leaves(jp), leaves(tp.tree()), want_g):
        mask = np.abs(gw) >= 1e-3 * np.abs(gw).max()
        d = np.abs(t.detach().numpy() - np.asarray(w))[mask]
        assert d.size == 0 or float(d.max()) <= 2e-6


@pytest.mark.parametrize("microbatches", [1, 2])
def test_recurrentgemma_tiny_step_matches_jitted_reference(microbatches):
    check_one_step("recurrentgemma-2b", microbatches)


def test_grad_accumulation_needs_param_dtype():
    import dataclasses
    cfg = dataclasses.replace(treg.get_tiny("yi-6b"),
                              grad_accum_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="accumulation"):
        tmake(cfg, tad.AdamW(), tad.cosine_schedule(1e-3, 2, 10))
