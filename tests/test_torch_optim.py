"""The port's optimizer (``repro_torch.optim.adamw``) against the JAX
package's, compiled (``jax.jit``), on the same numpy inputs: ``AdamW``'s
init and six updates with f32 and bf16 moments (leaves of 1, 2 and 3
dims, so the decay rule is exercised), ``global_norm``,
``clip_by_global_norm`` (clipping and not) and ``cosine_schedule`` over
warmup, decay and past the end.

Parity levels reached:
* The first update, the step count and the bias corrections: bit for
  bit.  ``torch.pow`` on the host equals XLA's ``power`` (checked over
  3,000 counts while the port was written).
* Later updates: XLA contracts the reference's ``b1 * m + (1 - b1) * g``
  (and the second moment's sum) into one fused multiply-add, where the
  port rounds the product and the sum separately (as all of the port
  does; ROADMAP C, "Scan order and FMA").  Moments within 8 ulps
  (4 seen), parameters within 2 ulps, both with an absolute floor of
  1e-9 for values near 0.
* ``global_norm``, clipping: within 1e-6 relative (the sums run in
  another order).
* The schedule: its warmup bit for bit (XLA folds ``base_lr * (s + 1) /
  warmup`` into ``(s + 1) * f32(base_lr * (1 / warmup))``, and the port
  does the same); the cosine part within ``base_lr * 2**-22``, a couple
  of ulps of ``cos`` (libm's against XLA's) times ``base_lr / 2``, which
  near the end of the decay is several ulps of the small rate itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jad
from repro_torch.optim import adamw as tad
from repro_torch.tree import leaves

SHAPES = {"w": (7, 5), "b": (11,), "blk": {"conv": (3, 4, 6), "ln": (9,)}}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _within(got, want, ulps, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    ok = (_ulps(got, want) <= ulps) | (np.abs(got - want) <= 1e-9)
    assert ok.all(), (what, float(np.abs(got - want).max()),
                      int(_ulps(got, want).max()))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_updates_match_jitted_reference(state_dtype):
    rng = np.random.default_rng(0)
    jopt = jad.AdamW(state_dtype=state_dtype)
    topt = tad.AdamW(state_dtype=state_dtype)
    p = _tree(rng, SHAPES)
    jp = _map(jnp.asarray, p)
    tp = _map(lambda x: torch.from_numpy(x.copy()), p)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.count.dtype == torch.int32 and int(ts.count) == 0
    for m in leaves(ts.m) + leaves(ts.v):
        assert m.dtype == getattr(torch, state_dtype) and not m.any()
    update = jax.jit(jopt.update)
    for it in range(6):
        g = _tree(rng, SHAPES, 10.0 ** (it - 3))
        lr = np.float32(1e-3 * (it + 1))
        jp, js = update(_map(jnp.asarray, g), js, jp, jnp.float32(lr))
        tp, ts = topt.update(_map(torch.from_numpy, g), ts, tp, lr)
        assert int(ts.count) == int(js.count) == it + 1
        for name, want, got in (("params", jp, tp), ("m", js.m, ts.m),
                                ("v", js.v, ts.v)):
            for w, t in zip(jax.tree.leaves(want), leaves(got)):
                if it == 0:
                    assert np.array_equal(_np(t), np.asarray(w, np.float32)), \
                        (name, it)
                else:
                    _within(_np(t), w, 2 if name == "params" else 8,
                            f"{name} after update {it + 1}")


def test_weight_decay_only_on_leaves_of_two_dims_or_more():
    p = {"w": torch.ones(2, 3), "b": torch.ones(3)}
    g = {"w": torch.zeros(2, 3), "b": torch.zeros(3)}
    opt = tad.AdamW(weight_decay=0.5)
    p, _ = opt.update(g, opt.init(p), p, 0.1)
    assert torch.equal(p["b"], torch.ones(3))
    assert torch.allclose(p["w"], torch.full((2, 3), 0.95))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 100.0])
def test_global_norm_and_clip_match_reference(scale):
    rng = np.random.default_rng(1)
    g = _tree(rng, SHAPES, scale)
    jn = jax.jit(jad.global_norm)(_map(jnp.asarray, g))
    tn = tad.global_norm(_map(torch.from_numpy, g))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    jclip, jn2 = jax.jit(lambda t: jad.clip_by_global_norm(t, 1.0))(
        _map(jnp.asarray, g))
    tg = _map(lambda x: torch.from_numpy(x.copy()), g)
    tclip, tn2 = tad.clip_by_global_norm(tg, 1.0)
    assert tclip is tg                       # in place
    np.testing.assert_allclose(float(tn2), float(jn2), rtol=1e-6)
    for w, t in zip(jax.tree.leaves(jclip), leaves(tclip)):
        np.testing.assert_allclose(_np(t), np.asarray(w), rtol=1e-6,
                                   atol=1e-12)
    if float(jn) <= 1.0:                     # no clip: untouched
        for x, t in zip(leaves(g), leaves(tclip)):
            assert np.array_equal(x, _np(t))


@pytest.mark.parametrize("base,warmup,total", [(3e-4, 10, 100),
                                               (3e-3, 10, 60),
                                               (1e-3, 7, 13),
                                               (2.5e-4, 0, 50)])
def test_cosine_schedule_matches_jitted_reference(base, warmup, total):
    jf = jax.jit(jad.cosine_schedule(base, warmup, total))
    tf = tad.cosine_schedule(base, warmup, total)
    for s in range(total + 5):
        want = np.float32(jf(jnp.int32(s)))
        got = tf(s)
        assert isinstance(got, np.float32)
        if s < warmup:
            assert got == want, s
        else:
            assert abs(float(got) - float(want)) <= base * 2.0 ** -22, \
                (s, got, want)
