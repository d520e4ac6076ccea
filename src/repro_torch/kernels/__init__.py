"""Hand-written CUDA kernels of the port, one wrapper module per kernel.

* :mod:`.simstep` — the simulator's event loop (replaces the TPU kernel
  ``repro/kernels/simstep.py::fused_chunk``).
* :mod:`.build` — builds ``csrc/*.cu`` with ``nvcc`` at first use and
  loads them with ``ctypes``.
"""
