"""Dispatch of the model layers to the port's kernels.

Each entry point takes the JAX package's layout and sends its tensors to
the kernel's wrapper, which launches the CUDA kernel on CUDA tensors (for
every shape the kernel takes: unlike the reference's dispatch there is no
small-shape detour to the oracle) and runs the plain version on CPU
tensors.  The mLSTM block calls :func:`mlstm_scan`.
"""

from __future__ import annotations

from repro_torch.kernels import mlstm_scan as _mlstm


def mlstm_scan(q, k, v, i_gate, f_gate, carry=None):
    """q,k,v: [B,H,S,dh]; gates: [B,H,S] -> (h [B,H,S,dh], (C, n, m)).
    Gates are taken in f32 and every operand contiguous, as the kernel
    takes them."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    i_gate, f_gate = (t.float().contiguous() for t in (i_gate, f_gate))
    if carry is not None:
        carry = tuple(t.float().contiguous() for t in carry)
    return _mlstm.mlstm_scan(q, k, v, i_gate, f_gate, carry)
