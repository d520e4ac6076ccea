"""Hand-written CUDA kernels of the port, one wrapper module per kernel.

* :mod:`.simstep` — the simulator's event loop (replaces the TPU kernel
  ``repro/kernels/simstep.py::fused_chunk``).
* :mod:`.mlstm_scan` — the mLSTM matrix-memory scan (replaces the TPU
  kernel ``repro/kernels/mlstm_scan.py::mlstm_scan``); its plain version
  is in :mod:`.ref`, and :mod:`.ops` dispatches the model layers to it.
* :mod:`.flash_attention` — forward attention of a prefill (replaces the
  TPU kernel ``repro/kernels/flash_attention.py::flash_attention``).
* :mod:`.decode_attention` — one decode step's attention against the KV
  cache (replaces the TPU kernel
  ``repro/kernels/decode_attention.py::decode_attention``).
  Their plain versions are in :mod:`.ref`, and :mod:`.ops` dispatches the
  attention layers to them.
* :mod:`.flash_attention_bwd` — the attention backward of training
  (replaces the TPU kernel
  ``repro/kernels/flash_attention_bwd.py::flash_attention_bwd``) and
  ``FlashAttentionFn``, which :mod:`.ops` runs when a gradient is asked.
* :mod:`.rglru_scan` — the RG-LRU linear recurrence (replaces the TPU
  kernel ``repro/kernels/rglru_scan.py::rglru_scan``); its plain version
  is in :mod:`.ref`, and :mod:`.ops` dispatches the RG-LRU blocks to it;
  ``RGLRUScanFn`` runs it reversed for the backward.
* :mod:`.build` — builds ``csrc/*.cu`` with ``nvcc`` at first use and
  loads them with ``ctypes``.
"""
