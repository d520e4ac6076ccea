"""The train step: the JAX package's ``repro/train/step.py`` on
PyTorch.

``make_train_step`` returns
``(params, opt_state, step, batch) -> (params, opt_state, step + 1,
metrics)`` in the reference's order of operations: one loss-and-grad per
microbatch (a leading split of the batch), the gradients summed and
divided by ``microbatches``, clipped at ``clip_norm`` by their global
norm, then one AdamW update at ``lr_fn(step)``.  The update is in place
(there is no buffer donation to mirror), and the gradients accumulate in
the parameters' ``.grad``, which autograd sums into; they are dropped
after the update, so a step holds them only while it runs.

Each microbatch's forward and loss run inside the profiler range
``repro_torch.forward``, the divide, clip and update inside
``repro_torch.optimizer`` (``chip_smoke.py`` splits a step's card time by
them).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.models import lm
from repro_torch.models.config import DTYPES, ModelConfig
from repro_torch.optim.adamw import AdamW, clip_by_global_norm
from repro_torch.tree import leaves, tree_map


def make_train_step(cfg: ModelConfig, opt: AdamW, lr_fn, *,
                    microbatches: int = 1, clip_norm: float = 1.0,
                    **kernels):
    """``kernels`` name other implementations of the kernels' functions
    for the model (as :func:`repro_torch.models.lm.loss_fn` takes them)."""
    acc_dt = DTYPES[getattr(cfg, "grad_accum_dtype", "float32")]
    if acc_dt != DTYPES[cfg.param_dtype]:
        raise NotImplementedError(
            f"gradient accumulation in {cfg.grad_accum_dtype} for "
            f"{cfg.param_dtype} parameters is not ported (the port "
            f"accumulates in the parameters' .grad)")

    def train_step(params, opt_state, step, batch):
        ptree = params.tree()
        plist = leaves(ptree)
        for p in plist:
            p.grad = None
        n = batch["tokens"].shape[0]
        if n % microbatches:
            raise ValueError(f"a batch of {n} does not split into "
                             f"{microbatches} microbatches")
        per = n // microbatches
        loss = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
        for i in range(microbatches):
            mb = {k: x[i * per:(i + 1) * per] for k, x in batch.items()}
            with record_function("repro_torch.forward"):
                l, _ = lm.loss_fn(params, cfg, mb, **kernels)
            l.backward()
            loss = loss + l.detach()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), ptree)
        with record_function("repro_torch.optimizer"):
            if microbatches > 1:
                with torch.no_grad():
                    for g in leaves(grads):
                        g.div_(microbatches)
                loss = loss / microbatches
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            lr = lr_fn(step)
            params, opt_state = opt.update(grads, opt_state, params, lr)
        del grads
        for p in plist:
            p.grad = None
        return params, opt_state, step + 1, {"loss": loss, "grad_norm": gnorm,
                                             "lr": lr}

    return train_step
