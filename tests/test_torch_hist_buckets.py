"""The streaming histogram's bucket index in the port against the JAX
package's, compiled as its simulator records a sample (``_hist_record``:
``1 + floor((log2(max(v, 1e-6)) - log2_lo) * inv_log2g)``, clipped), over
every latency a run of the paper's load figures can record: each integer
tick from 0 to the longest horizon, 80,000 us stretched by the largest
ratio of ``paper_figs._LOADLAT_EV8MS``.  XLA fuses ``log2``'s multiply
into the subtraction; the port does the same.  The reference side is
``_hist_record``'s expression jitted alone (the fusion is local to it),
checked against ``_hist_record`` itself on the first 2^18 ticks and
around every bucket edge.  Tolerance: exact."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from benchmarks import paper_figs
from repro.core import simlock as rsl
from repro_torch.core import simlock as sl

CHUNK = 1 << 22
CFG = rsl.SimConfig(hist=True)
TB = rsl.build_tables(CFG)
LO, INV = np.float32(TB.hist_log2_lo), np.float32(TB.hist_inv_log2g)
NB = CFG.hist_buckets


@jax.jit
def _expr(v, lo, inv):
    """``_hist_record``'s bucket expression."""
    lg = (jnp.log2(jnp.maximum(v, jnp.float32(1e-6))) - lo) * inv
    return jnp.clip(1 + jnp.floor(lg).astype(jnp.int32), 0, NB - 1)


@jax.jit
def _record(v, lo, inv):
    """The bucket ``_hist_record`` itself adds each sample to."""
    tbl = TB._replace(hist_log2_lo=lo, hist_inv_log2g=inv)
    hist = jnp.zeros((1, NB), jnp.uint32)
    return jax.vmap(lambda x: rsl._hist_record(
        hist, tbl, 0, x, True)[0].argmax())(v)


def _bucket(v: np.ndarray) -> np.ndarray:
    """The port's bucket (``simlock._hist_record``'s index)."""
    lg = sl.xm.fma(sl.xm.log(torch.clamp_min(torch.from_numpy(v),
                                             sl._HIST_FLOOR)),
                   sl.xm.LOG2_MUL, -torch.tensor([LO])) * torch.tensor([INV])
    return torch.clamp(1 + torch.floor(lg).to(torch.int32), 0,
                       NB - 1).numpy()


def test_bucket_index_every_reachable_tick():
    ev = paper_figs._LOADLAT_EV8MS
    horizon = sl.ticks(80_000.0 * max(ev.values()) / min(ev.values()))
    assert horizon > 5.04e7
    edges = []
    for start in range(0, horizon + 1, CHUNK):
        v = np.arange(start, min(start + CHUNK, horizon + 1),
                      dtype=np.int64).astype(np.float32)
        want = np.asarray(_expr(v, LO, INV))
        got = _bucket(v)
        bad = np.nonzero(got != want)[0]
        assert bad.size == 0, (v[bad[:5]], got[bad[:5]], want[bad[:5]])
        edges += v[1:][np.diff(want) != 0].tolist()
    assert len(edges) > 300
    # The copied expression is _hist_record's, near every edge.
    near = np.unique(np.clip(np.add.outer(np.asarray(edges, np.int64),
                                          np.arange(-8, 8)).ravel(),
                             0, horizon))
    v = np.concatenate([np.arange(1 << 18), near]).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(_record(v, LO, INV)),
                                  np.asarray(_expr(v, LO, INV)))
