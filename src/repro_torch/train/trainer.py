"""Fault-tolerant training loop: checkpoint/restart, preemption handling,
straggler detection and the bounded-staleness hook — the JAX package's
``repro/train/trainer.py`` on one CUDA device (or the CPU, for tests).

* **Restart-safe**: the step counter keys both the data stream (stateless
  bijective shuffle) and the LR schedule, and the kernels have no atomics,
  so ``restore -> resume`` repeats an uninterrupted run bit for bit.
* **Preemption**: SIGTERM/SIGUSR1 set a flag; the loop checkpoints at the
  next step boundary and exits cleanly.
* **Straggler hook**: a :class:`BoundedStalenessController` decides
  whether this pod may commit ahead (policy-only on one host).
* Step-time anomaly detection: a step slower than ``straggler_factor`` x
  the EWMA is logged as a straggler event.
* ``history`` holds one entry a step: its loss, grad norm, lr and
  seconds (``dt``), and ``ckpt_s``, the seconds of the save that followed
  it, where one did.

There are no shardings on one card: ``shardings`` must be ``None``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time

import torch

from repro_torch.ckpt.checkpointer import CheckpointManager
from repro_torch.data.pipeline import DataConfig, TokenDataset
from repro_torch.device import resolve
from repro_torch.dist.staleness import BoundedStalenessController
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    lr: float = 3e-4
    warmup: int = 10
    microbatches: int = 1
    global_batch: int = 8
    seq_len: int = 128
    seed: int = 0
    straggler_factor: float = 3.0


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, *,
                 shardings=None, staleness: BoundedStalenessController = None,
                 device=None):
        if shardings is not None:
            raise NotImplementedError(
                "the port trains on one card: shardings must be None")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve(device)
        self.opt = AdamW(state_dtype=cfg.opt_state_dtype)
        self.lr_fn = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)
        self.step_fn = make_train_step(cfg, self.opt, self.lr_fn,
                                       microbatches=tcfg.microbatches)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep,
                                      save_async=False)
        self.data = TokenDataset(DataConfig(
            vocab=cfg.vocab, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed))
        self.shardings = shardings
        self.staleness = staleness
        self._preempted = False
        self.history: list[dict] = []
        self.straggler_events: list[int] = []

    # ------------------------------------------------------------------
    def install_signal_handlers(self):
        def _handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGUSR1, _handler)

    # ------------------------------------------------------------------
    def state_tree(self, params, opt_state) -> dict:
        """The checkpointed tree, named as the reference names it."""
        return {"params": params.tree(), "opt": opt_state}

    def init_or_restore(self):
        params = lm.init_params(self.cfg, self.tcfg.seed, device=self.device,
                                requires_grad=True)
        opt_state = self.opt.init(params)
        step = 0
        latest = self.ckpt.latest()
        if latest is not None:
            self.ckpt.restore(latest, self.state_tree(params, opt_state),
                              self.shardings)
            step = latest
        return params, opt_state, step

    # ------------------------------------------------------------------
    def _device_batch(self, batch: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device, torch.long)
                for k, v in batch.items()}

    def run(self, max_steps: int = None) -> dict:
        params, opt_state, step = self.init_or_restore()
        horizon = min(self.tcfg.total_steps,
                      (step + max_steps) if max_steps else
                      self.tcfg.total_steps)
        ewma = None
        while step < horizon and not self._preempted:
            if self.staleness is not None and \
                    not self.staleness.can_commit(0):
                time.sleep(0.01)    # bounded: wait for the slowest pod
                continue
            batch = self.data.batch(step)
            t0 = time.monotonic()
            params, opt_state, _, metrics = self.step_fn(
                params, opt_state, step, self._device_batch(batch))
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > self.tcfg.straggler_factor * ewma and step > 2:
                self.straggler_events.append(step)
            step += 1
            if self.staleness is not None:
                self.staleness.commit(0)
            self.history.append({"step": step, "loss": loss, "dt": dt,
                                 "grad_norm": float(metrics["grad_norm"]),
                                 "lr": float(metrics["lr"])})
            if step % self.tcfg.ckpt_every == 0 or self._preempted or \
                    step >= horizon:
                t0 = time.monotonic()
                self.ckpt.save(step, self.state_tree(params, opt_state))
                self.history[-1]["ckpt_s"] = time.monotonic() - t0
        if self._preempted:
            self.ckpt.save(step, self.state_tree(params, opt_state))
        return {"step": step, "params": params, "opt": opt_state,
                "history": self.history, "preempted": self._preempted,
                "stragglers": self.straggler_events}
