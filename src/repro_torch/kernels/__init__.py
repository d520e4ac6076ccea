"""Hand-written CUDA kernels of the port, one wrapper module per kernel.

* :mod:`.simstep` — the simulator's event loop (replaces the TPU kernel
  ``repro/kernels/simstep.py::fused_chunk``).
* :mod:`.mlstm_scan` — the mLSTM matrix-memory scan (replaces the TPU
  kernel ``repro/kernels/mlstm_scan.py::mlstm_scan``); its plain version
  is in :mod:`.ref`, and :mod:`.ops` dispatches the model layers to it.
* :mod:`.build` — builds ``csrc/*.cu`` with ``nvcc`` at first use and
  loads them with ``ctypes``.
"""
