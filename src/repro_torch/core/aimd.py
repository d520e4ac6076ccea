"""AIMD reorder-window controller — Algorithm 2 of the paper.

On an SLO violation the window halves and the additive unit is recomputed
as ``window * (100 - PCT) / 100``; every epoch end adds one unit.

* :class:`AIMDWindow` — the host-side scalar form.
* :func:`aimd_update` — the batched tensor form the simulator's plain
  step uses, bit-identical to the JAX package's form *as its simulator
  runs it*, compiled: XLA folds ``w * (100 - pct) / 100`` into one
  multiply, ``w * (f32(100 - pct) * f32(1 / 100))`` (:func:`unit_factor`),
  which rounds differently from the division that eager JAX computes.
  The factor is a tensor on the window's device, and the remaining order
  is the reference's: halve, unit, then ``clip(w + u)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_WINDOW = 1_000.0
DEFAULT_UNIT = 10.0
MAX_WINDOW = 100_000_000.0  # paper: 100ms upper bound => starvation-free
MIN_WINDOW = 0.0


def unit_factor(pct: float = 99.0) -> np.float32:
    """The f32 factor of the compiled unit: ``f32(100 - pct) * (1 / 100)``
    with both constants rounded to f32, as XLA folds them."""
    return np.float32(100.0 - pct) * (np.float32(1.0) / np.float32(100.0))


def unit_for(window, pct: float = 99.0):
    """The additive-increase unit for a window at violation percentile
    ``pct``: ``window * (100 - pct) / 100``.  A Python float is computed
    in double (host side, as the reference does); an f32 tensor is
    multiplied by :func:`unit_factor`, as the reference's compiled
    simulator does."""
    if isinstance(window, torch.Tensor):
        return window * torch.tensor(unit_factor(pct), dtype=torch.float32,
                                     device=window.device)
    return window * (100.0 - pct) / 100.0


@dataclasses.dataclass
class AIMDWindow:
    """Per-(thread, epoch-id) reorder window state (paper Algorithm 2)."""

    window: float = DEFAULT_WINDOW
    unit: float = DEFAULT_UNIT
    pct: float = 99.0
    max_window: float = MAX_WINDOW

    def update(self, latency: float, slo: float) -> float:
        if latency > slo:
            self.window = self.window / 2.0
            self.unit = unit_for(self.window, self.pct)
        self.window = min(self.window + self.unit, self.max_window)
        self.window = max(self.window, MIN_WINDOW)
        return self.window


def aimd_update(window, unit, latency, slo, *, pct=99.0,
                max_window=MAX_WINDOW):
    """Functional Algorithm 2 step on f32 tensors of one shape."""
    violated = latency > slo
    w = torch.where(violated, window * 0.5, window)
    u = torch.where(violated, unit_for(w, pct), unit)
    w = torch.clamp(w + u, MIN_WINDOW, float(max_window))
    return w, u
