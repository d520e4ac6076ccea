"""PyTorch/CUDA port of the asymmetry-aware lock simulator.

Mirrors ``repro`` path for path; the JAX package stays the reference and
this package imports nothing of it (nor of ``jax``).  So far it holds the
closed-loop slice of the batched lock simulator
(:mod:`repro_torch.core.simlock`: ``SimConfig`` -> ``sweep`` / ``run`` ->
``sweep_summaries`` / ``summarize``) for the ``fifo``, ``tas``, ``prop``
and ``libasl`` policies, whose event loop runs in a hand-written CUDA
kernel (:mod:`repro_torch.kernels.simstep`).  Entry points run on the
CUDA device unless given ``device="cpu"``.
"""
